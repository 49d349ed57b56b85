"""Training launcher (PyTorch port).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 --seq 256 --batch 8 [--smoke] [--resume]

The JAX package's flags, plus ``--torch-device`` (default ``cuda``; ``cpu``
trains on the CPU).  The config runs as given on one device: ``--smoke``
takes its reduced twin.  Checkpoints go to ``--ckpt-dir`` (by default
``repro_torch_ckpt`` under the temporary directory).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.training.data import DataConfig
from repro_torch.training.fault_tolerance import FailureInjector
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=TrainerConfig().ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to train on (cuda | cpu)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    inj = FailureInjector(fail_at_steps=(args.fail_at,)) if args.fail_at \
        else None
    trainer = Trainer(
        cfg, dc,
        AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                    total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      microbatches=args.microbatches),
        failure_injector=inj, device=args.torch_device)
    losses = trainer.run(resume=args.resume)
    print(f"first loss: {losses[0]:.4f}")
    print(f"final loss: {losses[-1]:.4f} ({len(losses)} steps this run)")
    return losses


if __name__ == "__main__":
    main()
