"""Checkpoint management with lease-guarded writers and async I/O (the
port of ``repro.checkpoint.manager``).

The writer-election problem ("exactly one process should write step-aligned
checkpoints, even across partitions/failovers") is solved with a PaxosLease
instance on ``ckpt-writer``: the holder writes, everyone else doesn't, and a
hung writer loses the lease after T without any fencing protocol. The guard
is injected as a callable so the manager works both under the simulated
control plane and standalone (guard = always-true)."""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from .io import restore_checkpoint, save_checkpoint


class CheckpointManager:
    def __init__(
        self,
        ckpt_dir: str,
        *,
        every_steps: int = 100,
        keep: int = 3,
        lease_guard: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.ckpt_dir = ckpt_dir
        self.every_steps = every_steps
        self.keep = keep
        self.lease_guard = lease_guard or (lambda: True)
        self.saved_steps: list[int] = []
        self.skipped_no_lease = 0

    def maybe_save(self, step: int, state_fn: Callable[[], dict]) -> bool:
        """state_fn is called only if we actually save (no copy to the host
        otherwise)."""
        if step % self.every_steps != 0:
            return False
        if not self.lease_guard():
            self.skipped_no_lease += 1
            return False
        save_checkpoint(self.ckpt_dir, step, state_fn(), keep=self.keep)
        self.saved_steps.append(step)
        return True

    def restore_latest(self, *, device=None):
        return restore_checkpoint(self.ckpt_dir, device=device)


class AsyncCheckpointer:
    """Background-thread writer: the training loop hands over (step, state)
    snapshots (host copies, taken before the next step changes the
    tensors) and keeps stepping: compute/IO overlap. One in-flight save at a
    time; extra requests are coalesced to the newest."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 lease_guard: Optional[Callable[[], bool]] = None) -> None:
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.lease_guard = lease_guard or (lambda: True)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._stop = threading.Event()
        self.saved_steps: list[int] = []
        self.errors: list[str] = []
        self._thread.start()

    def submit(self, step: int, state: dict) -> bool:
        if not self.lease_guard():
            return False
        try:
            self._q.put_nowait((step, state))
            return True
        except queue.Full:  # coalesce: drop the older pending snapshot
            try:
                self._q.get_nowait()
                self._q.task_done()
            except queue.Empty:
                pass
            self._q.put_nowait((step, state))
            return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                step, state = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                save_checkpoint(self.ckpt_dir, step, state, keep=self.keep)
                self.saved_steps.append(step)
            except Exception as e:  # pragma: no cover
                self.errors.append(f"step {step}: {e!r}")
            finally:
                self._q.task_done()

    def close(self, *, flush: bool = True) -> None:
        """Stops the writer; with ``flush`` (up to 30 s) after every
        submitted snapshot is written: a snapshot counts as pending from
        ``submit`` until its write ends, so none is missed between the
        queue and the writer."""
        if flush:
            deadline = time.time() + 30
            while self._q.unfinished_tasks and time.time() < deadline:
                time.sleep(0.01)
        self._stop.set()
        self._thread.join(timeout=5)
