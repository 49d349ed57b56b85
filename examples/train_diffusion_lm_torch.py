"""Train a block-diffusion LM for a few hundred steps with checkpointing and
a mid-run failure/restart drill (fault-tolerance demonstration).  The
``repro_torch`` twin of ``examples/train_diffusion_lm.py``: the same
configurations, schedule, failure and printed lines.

By default trains a ~14M-parameter model; ``--full`` trains the real
smollm-135m config at full width and depth in fp32 (same code path as
``repro_torch.launch.train``).  On a CUDA device the ``Trainer`` replays
each step as one captured CUDA graph.

    PYTHONPATH=src python examples/train_diffusion_lm_torch.py [--steps 200]
        [--full] [--torch-device cpu]

The weights come from a ``torch.Generator`` seeded with the trainer's
seed; the reference's come from a per-process salted string hash, so the
two scripts' losses differ while the run's structure (failure step,
checkpoints, resumed step, learning rates) is the same.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.models import ArchConfig
from repro_torch.training import (AdamWConfig, DataConfig, FailureInjector,
                                  SimulatedFailure, Trainer, TrainerConfig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true", help="train smollm-135m")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_example_ckpt"),
                    help="checkpoint directory (emptied first)")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to train on (cpu | cuda)")
    return ap.parse_args(argv)


def configs(args):
    """(arch, data, optimizer, trainer) configs of the run ``args`` asks
    for, as the reference builds them."""
    if args.full:
        cfg = get_config("smollm-135m").replace(param_dtype="float32",
                                                compute_dtype="float32",
                                                remat=False)
    else:
        cfg = ArchConfig(name="diffusion-14m", family="dense", n_layers=6,
                         d_model=384, n_heads=6, n_kv_heads=2, d_ff=1024,
                         vocab_size=8192, block_size=16)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=args.steps // 20,
                      total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.steps // 4,
                       ckpt_dir=args.ckpt,
                       log_every=max(args.steps // 10, 1))
    return cfg, dc, opt, tc


def torch_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device with no card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --torch-device cpu to run "
                           "on the CPU")
    return dev


def main(argv=None, before_restart=None) -> dict:
    """The drill: train with a failure injected, then restart from the
    latest checkpoint and finish.  ``before_restart(trainer)``, when given,
    sees the restarting trainer before it restores.  Returns the failure's
    step, the step resumed from, both runs' losses, the restarted run's
    median step time and its graph cache's replays."""
    args = parse_args(argv)
    dev = torch_device(args.torch_device)
    cfg, dc, opt, tc = configs(args)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    fail_step = args.steps // 2 + 5
    print(f"training {cfg.name} for {args.steps} steps "
          f"(injected failure at step {fail_step}, restart from checkpoint)\n")
    trainer = Trainer(cfg, dc, opt, tc, device=dev,
                      failure_injector=FailureInjector(
                          fail_at_steps=(fail_step,)))
    failed = None
    try:
        first = trainer.run(resume=False)
    except SimulatedFailure as e:
        print(f"\n*** {e} — restarting from latest checkpoint ***\n")
        failed = fail_step
        first = None
    trainer.graphs = None        # the cache holds the failed run's state

    trainer2 = Trainer(cfg, dc, opt, tc, device=dev)
    if before_restart is not None:
        before_restart(trainer2)
    resumed_from = trainer2.ckpt.latest_step()
    losses = trainer2.run(resume=True)
    print(f"\nrecovered and finished: final loss {losses[-1]:.4f}")
    print(f"straggler report: p50 step time "
          f"{trainer2.monitor.fleet_p50()*1e3:.0f} ms, "
          f"stragglers: {trainer2.monitor.stragglers()}")
    replays = None if trainer2.graphs is None else trainer2.graphs.replays
    trainer2.graphs = None
    return {"arch": cfg.name, "failed_at": failed,
            "resumed_from": resumed_from, "first_run_losses": first,
            "losses": losses, "p50_step_s": trainer2.monitor.fleet_p50(),
            "stragglers": trainer2.monitor.stragglers(),
            "graph_replays": replays}


if __name__ == "__main__":
    main()
