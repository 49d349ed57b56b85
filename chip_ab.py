#!/usr/bin/env python3
"""Serve SDAR-8B from two checkouts of the repository in turns on one GPU.

    python3 chip_ab.py PARENT_DIR [--out results.json]

``PARENT_DIR`` holds another checkout (e.g. ``git archive <commit>``
unpacked).  Each turn is a fresh process with that checkout's ``src/`` on
its path, running the same driver: build the kernels, draw SDAR-8B at full
width and depth from the seed, and serve phase 7's 8 requests through
``ModelBackend`` and ``ServingEngine`` — elastic scheduling (as
``launch/serve.py`` builds it) with chunked prefill, then with wave
prefill — timing ``engine.run`` to the card's last kernel.  The turns go
parent, this checkout, this checkout, parent, twice, so both sides see
the card and its host alike; compare within one call only.
Prints one line a turn and, last, a JSON object of every turn's wall,
committed tok/s and a hash of the committed tokens; needs one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_TURN = r'''
import hashlib, json, sys, time
import numpy as np
import torch
sys.path.insert(0, "src")
from repro_torch.configs import get_config
from repro_torch.core.latency_model import CPU_HOST, AnalyticDeviceModel
from repro_torch.core.scheduler import ElasticScheduler
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.serving import DATASETS, ModelBackend, Request, ServingEngine
torch.backends.cuda.matmul.allow_tf32 = False
build.build(build.all_sources())
cfg = get_config("sdar-8b")
model = build_model(cfg)
params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
out = {}
for mode in ("chunked", "wave"):
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        p = int(rng.integers(128, 513))
        reqs.append(Request(rid=i, arrival_time=0.0, prompt_len=p,
                            max_new_tokens=int(rng.integers(64, 129)),
                            prompt_tokens=rng.integers(
                                4, cfg.vocab_size - 8, p).tolist()))
    be = ModelBackend(model, params, n_slots=8, max_len=1024,
                      cache_dtype=torch.bfloat16, device="cuda",
                      prefill_mode=mode)
    sched = ElasticScheduler.from_analytic(
        AnalyticDeviceModel(cfg, CPU_HOST),
        prior_tokens_per_step=DATASETS["sharegpt"].tokens_per_step_bd32,
        batches=(1, 2, 4, 8), ctx=128.0)
    toks, release = {}, be.release
    def spy(rid):
        toks[rid] = list(be.state(rid).output_tokens)
        release(rid)
    be.release = spy
    eng = ServingEngine(be, sched, max_batch=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sum(len(v) for v in toks.values())
    out[mode] = {"wall_s": wall, "tok_per_s": n / wall,
                 "tokens_committed": n,
                 "decode_dispatches": be.decode_dispatches,
                 "prefill_dispatches": be.prefill_dispatches,
                 "tokens_sha1": hashlib.sha1(json.dumps(
                     [toks[r] for r in sorted(toks)]).encode()).hexdigest()}
    del be, eng
    torch.cuda.empty_cache()
print("AB " + json.dumps(out))
'''


def turn(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _TURN], cwd=str(root),
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
    return json.loads(line[-1][3:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available", file=sys.stderr)
        return 2
    parent = Path(args.parent).resolve()
    runs = []
    for side in ("parent", "change", "change", "parent") * 2:
        res = turn(parent if side == "parent" else ROOT)
        runs.append({"side": side, **res})
        print(side, json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
