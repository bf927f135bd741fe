"""Training loop (the port of ``repro.train.loop``): the train step of
``launch.steps`` with microbatch gradient accumulation, lease-guarded
(async) checkpoints, and resume from the latest checkpoint at
construction.

Runs on the card unless given ``device="cpu"``. When torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) says the world
is larger than one, the trainer initialises the default process group
(NCCL on the card, each rank on ``cuda:LOCAL_RANK``; gloo on the CPU),
builds the data = world, model = 1 mesh, and trains data-parallel: each
rank takes its contiguous slice of every global batch of
``tc.batch_size`` rows, and the gradients are averaged across the ranks
before the clip and AdamW (``launch.steps.accumulate_grads``). Rank 0
alone writes checkpoints (and runs the lease guard); every rank resumes
from them. With a world of one nothing of this runs and no process group
is created. Fault-tolerance hooks, as
the reference's: ``on_step`` (straggler/fault injection in tests), the
lease guard of the checkpoint writer, and the lease-driven shard set of the
loader (``owned_shards``). Weights come from the port's own generator
(``init_model(cfg, tc.seed)``), so the same seed gives other weights than
the reference's; the tests carry the reference's weights across instead.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..checkpoint import AsyncCheckpointer, CheckpointManager, latest_step, restore_checkpoint
from ..configs.base import ModelConfig
from ..data import ShardedLoader, SyntheticTokens
from ..device import resolve_device
from ..launch.mesh import dp_world, init_data_parallel
from ..launch.steps import make_train_step, shard_batch
from ..models import init_model
from ..models.schema import map_tree
from ..optim import adamw_init
from ..parallel.sharding import use_mesh


@dataclass
class TrainerConfig:
    steps: int = 100
    batch_size: int = 8
    seq_len: int = 128
    peak_lr: float = 3e-4
    warmup: int = 20
    microbatches: int = 1  # gradient accumulation
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_async: bool = False
    keep: int = 3
    n_shards: int = 8
    seed: int = 0
    log_every: int = 10


@torch.no_grad()
def _load_into(dst: dict, src: dict) -> None:
    """Copies a restored tree into ``dst``'s tensors (their dtypes kept)."""
    if set(dst) != set(src):
        raise ValueError(f"checkpoint keys {sorted(src)} do not match {sorted(dst)}")
    for k, v in dst.items():
        if isinstance(v, dict):
            _load_into(v, src[k])
        else:
            v.copy_(torch.as_tensor(src[k]).to(v.device).reshape(v.shape))


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tc: TrainerConfig,
        *,
        lease_guard: Optional[Callable[[], bool]] = None,
        owned_shards: Optional[Callable] = None,
        verbose: bool = True,
        device="cuda",
    ) -> None:
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.rank, self.world, local_rank = dp_world()
        if self.world > 1 and self.device.type == "cuda":
            self.device = torch.device("cuda", local_rank)
            torch.cuda.set_device(self.device)
        #: the data = world, model = 1 mesh (None for a world of one)
        self.mesh = init_data_parallel(self.device)
        if self.mesh is None:
            self.rank, self.world = 0, 1
        self.verbose = verbose and self.rank == 0
        self.gen = SyntheticTokens(cfg.vocab_size, tc.seq_len, seed=tc.seed)
        self.loader = ShardedLoader(self.gen, tc.n_shards, tc.batch_size, owned_shards=owned_shards)
        self.step = 0
        self.history: list[dict] = []

        self.params = init_model(cfg, tc.seed, device=self.device)
        self.opt_state = adamw_init(self.params)
        # resume if a checkpoint exists
        if tc.ckpt_dir and latest_step(tc.ckpt_dir) is not None:
            state, step = restore_checkpoint(tc.ckpt_dir, device=self.device)
            _load_into(self.params, state["params"])
            _load_into(self.opt_state, state["opt"])
            self.step = step
            if self.verbose:
                print(f"[trainer] resumed from step {step}")

        self.ckpt = None
        self.async_ckpt = None
        if tc.ckpt_dir and self.rank == 0:
            if tc.ckpt_async:
                self.async_ckpt = AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep,
                                                    lease_guard=lease_guard)
            else:
                self.ckpt = CheckpointManager(tc.ckpt_dir, every_steps=tc.ckpt_every,
                                              keep=tc.keep, lease_guard=lease_guard)

        self._train_step = make_train_step(
            cfg, peak_lr=tc.peak_lr, warmup=tc.warmup, total=tc.steps,
            microbatches=tc.microbatches,
            dp_group=None if self.mesh is None else self.mesh.get_group("data"))

    # ------------------------------------------------------------------ run
    def run(self, *, on_step: Optional[Callable[[int, dict], None]] = None) -> list[dict]:
        t_start = time.time()
        while self.step < self.tc.steps:
            batch = shard_batch(self.loader.next_batch(), self.rank, self.world)
            with use_mesh(self.mesh):
                self.params, self.opt_state, metrics = self._train_step(
                    self.params, self.opt_state, batch)
            self.step += 1
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = self.step
            self.history.append(m)
            if on_step:
                on_step(self.step, m)
            self._maybe_checkpoint()
            if self.verbose and self.step % self.tc.log_every == 0:
                dt = time.time() - t_start
                print(f"[trainer] step {self.step:5d} loss {m['loss']:.4f} "
                      f"lr {m['lr']:.2e} ({dt:.1f}s)", flush=True)
        if self.async_ckpt:
            self.async_ckpt.close()
        return self.history

    def _state_snapshot(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _maybe_checkpoint(self) -> None:
        if self.ckpt is not None:
            self.ckpt.maybe_save(self.step, self._state_snapshot)
        elif self.async_ckpt is not None and self.step % self.tc.ckpt_every == 0:
            # a host copy now: the next step updates the tensors in place
            snap = map_tree(self._state_snapshot(), lambda t: t.detach().to("cpu", copy=True))
            self.async_ckpt.submit(self.step, snap)
