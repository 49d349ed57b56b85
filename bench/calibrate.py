"""Readings that set the benchmark's numbers, each taken once on the card
when a cell is defined (never by the benchmark's own runs):

    python3 bench/calibrate.py gain  --config sdar-8b --traffic <mix>
    python3 bench/calibrate.py sweep --config sdar-8b --traffic <mix> \\
        --rates 2,3,4 --seconds 20
    python3 bench/calibrate.py seeds --config sdar-8b --traffic <mix> \\
        --seeds 1,2,3 --control 3 --seconds 20

``gain`` bisects the configuration's ``final_norm_gain`` so that bd32
decoding of the mix's prompts commits the mix's ``tokens_per_step_bd32``
tokens a request a dispatch; ``sweep`` serves the mix at each of
``--rates`` (in place of its own) and prints whether the backlog of
requests due without a first token grew through the window (the knee is
the highest rate at which it does not);
``seeds`` serves the mix once a seed, with the weights drawn again from
each seed into the same tensors, and prints the correctness check's
readings, and for the first ``--control`` seeds the control's: the
reference in float8 put in the program's place (at the mix's rate, or at
the one rate ``--rates`` gives).  One process builds the
system once (``--kv-pages`` may shrink the pool so the reference fits
beside it; the pool's size does not enter any computation).  Every line
printed is JSON; ``--out`` also writes them to a file.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import BENCH, _environment  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", help="gain, sweep, seeds, or several joined "
                    "by commas (a found gain is used by the modes after)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--gain", type=float, default=None)
    ap.add_argument("--kv-pages", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from harness import calib

    cfg = json.loads((BENCH / "configs" / f"{args.config}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{args.traffic}.json").read_text())
    if args.gain is not None:
        cfg["final_norm_gain"] = args.gain
    if args.kv_pages is not None:
        cfg["serve"]["kv_pages"] = args.kv_pages
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    sysm = calib.System(cfg, mix, args.seed, args.device, emit)
    emit({"setup": sysm.setup, "t": time.perf_counter() - T_START})
    for mode in args.mode.split(","):
        if mode == "gain":
            sysm.bisect_gain()
        elif mode == "sweep":
            for r in [float(x) for x in args.rates.split(",")]:
                sysm.serve(r, args.seed, args.seconds, judge=False)
        elif mode == "seeds":
            rate = float(args.rates) if args.rates else \
                mix["arrivals"]["rate"]
            for i, s in enumerate(int(x) for x in args.seeds.split(",")):
                sysm.redraw(s)
                sysm.serve(rate, s, args.seconds, judge=True,
                           control=i < args.control)
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
