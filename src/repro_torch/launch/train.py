"""Training launcher: the port of ``repro.launch.train``, plus ``--device``.

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path
on the CPU. With ``--coordinator process`` and a checkpoint directory an
in-process PaxosLease cell (``cluster.coordinator``) elects the checkpoint
writer, and the trainer writes only while it holds the lease.

Under torchrun the run is data-parallel over the ranks (``Trainer``): one
GPU a rank on NCCL (gloo with ``--device cpu``), the global batch of
``--batch-size`` rows split among them, and rank 0 alone running the lease
guard and writing checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch lm20m --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b --reduced --steps 20 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch internlm2-1.8b --batch-size 32 --seq-len 4096 --microbatches 4
"""
from __future__ import annotations

import argparse


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm20m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--coordinator", default="process", choices=["process", "none"],
                    help="'process': in-process lease cell guards the ckpt writer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import dp_world
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)

    lease_guard = None
    rank = dp_world()[0]
    if args.coordinator == "process" and args.ckpt_dir and rank == 0:
        # a single host still runs the real protocol (loopback cell): the
        # trainer writes checkpoints only while it holds the writer lease
        from repro_torch.cluster.coordinator import CKPT_RESOURCE, build_coordinated_cluster
        from repro_torch.configs.paxoslease_cell import DEFAULT_CELL

        cell, _ = build_coordinated_cluster(DEFAULT_CELL, n_workers=0, seed=0)
        node = cell.proposers[0]
        node.proposer.acquire(CKPT_RESOURCE, timespan=DEFAULT_CELL.lease_timespan)
        cell.env.run_until(2.0)

        def lease_guard() -> bool:
            cell.env.run_until(cell.env.now + 0.05)  # let renewals tick
            return node.proposer.is_owner(CKPT_RESOURCE)

    tc = TrainerConfig(
        steps=args.steps, batch_size=args.batch_size, seq_len=args.seq_len,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, ckpt_async=args.ckpt_async,
        log_every=max(args.steps // 20, 1),
    )
    tr = Trainer(cfg, tc, lease_guard=lease_guard, device=args.device)
    try:
        hist = tr.run()
    finally:
        if tr.mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"done on {tr.device} (rank {tr.rank} of {tr.world}): "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
