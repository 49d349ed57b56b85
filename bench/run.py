"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The last line of standard output is the result as one JSON object;
the numbers the correctness check compared, each beside its limit, are the
last lines of standard error and the result's last key.  See
``bench/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment():
    """Caches at fixed paths inside the checkout; few host threads."""
    cache = ROOT / "build" / "bench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from harness import runner
    from harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"bench: needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START,
                     log=lambda s: print(s, flush=True))
    bad = runner.forbidden_modules()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["checked"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
