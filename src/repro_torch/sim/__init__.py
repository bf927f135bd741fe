"""Discrete-event simulation (scheduler, network, node environment) for the
event-driven referee: a copy of ``repro.sim``, which the port may not
import. Pure Python; draws from ``random`` in the reference's order."""
from .events import Scheduler, TimerHandle
from .network import NetConfig, Network
from .env import SimEnv, StableStore

__all__ = ["NetConfig", "Network", "Scheduler", "SimEnv", "StableStore", "TimerHandle"]
