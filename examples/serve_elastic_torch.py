"""End-to-end serving demo: a real model served with batched requests
through the continuous-batching engine, Optimus elastic decoding vs AR and
fixed-block baselines.  The ``repro_torch`` twin of
``examples/serve_elastic.py``: the same model shape, workload, prompt
draws and printed lines.

    PYTHONPATH=src python examples/serve_elastic_torch.py [--requests 12]
        [--tight-pool] [--torch-device cpu]

The model, its page pool and the hand kernels run on ``--torch-device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions; there is no
fall-back from one to the other).  The attention family serves through
the unified paged KV pool (block tables + the chunked-paged-attention
kernel; on the card every dispatch replays a captured CUDA graph) with
**memory-elastic admission**: a request claims only its prompt's pages at
admit and grows page-by-page as chunks commit, so far more requests run
in flight than worst-case reservation would allow — and when the pool runs
dry mid-decode, the engine preempts a victim (freeing its pages) and
re-prefills it later.  ``--tight-pool`` demonstrates that preemption path.

The elastic run's scheduler is profiled on the analytic model of the
device the model runs on: ``CPU_HOST`` with ``--torch-device cpu`` (as the
reference, which runs on the CPU, profiles it), ``H100_SXM`` on ``cuda``.
So the elastic runs on the two devices may pick other chunks; the AR and
fixed-chunk runs do not depend on it.
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch

from repro_torch.core import ElasticScheduler, FixedScheduler
from repro_torch.core.latency_model import (CPU_HOST, H100_SXM,
                                            AnalyticDeviceModel)
from repro_torch.models import ArchConfig, build_model
from repro_torch.serving import (DATASETS, ModelBackend, PoissonWorkload,
                                 ServingEngine, chunk_distribution)

N_SLOTS, MAX_LEN = 8, 128

CFG = ArchConfig(name="serve-demo", family="dense", n_layers=2, d_model=128,
                 n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
                 block_size=8, confidence_threshold=0.6)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--out", type=int, default=24)
    ap.add_argument("--tight-pool", action="store_true",
                    help="also run with a page pool too small for everyone, "
                         "showing preemption-on-OutOfPages")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device the model, page pool and kernels run "
                         "on (cpu runs the plain versions)")
    return ap.parse_args(argv)


def torch_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device with no card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --torch-device cpu to run "
                           "on the CPU")
    return dev


class Demo:
    """The script's state: the model and its params on ``dev``, the
    arguments, and the prompt generator every workload draws from in turn
    (the reference's module-level ``rng``).  ``on_backend(name, be)`` and
    ``on_served(name, be, rep)``, when given, see each run's backend before
    and after it serves."""

    def __init__(self, args, params=None, on_backend=None, on_served=None):
        self.args = args
        self.dev = torch_device(args.torch_device)
        self.model = build_model(CFG)
        if params is None:
            params = self.model.init_params(
                torch.Generator(device=self.dev).manual_seed(0),
                device=self.dev)
        self.params = {k: v.to(self.dev) for k, v in params.items()}
        self.rng = np.random.default_rng(0)
        self.on_backend = on_backend
        self.on_served = on_served

    def workload(self, simultaneous=False):
        a = self.args
        wl = list(PoissonWorkload(DATASETS["sharegpt"], rate=50.0,
                                  n_requests=a.requests, seed=1))
        for r in wl:
            r.prompt_len = a.prompt
            r.max_new_tokens = a.out
            r.prompt_tokens = self.rng.integers(4, CFG.vocab_size,
                                                a.prompt).tolist()
            if simultaneous:
                r.arrival_time = 0.0
        return wl

    def backend(self, **kw):
        return ModelBackend(self.model, self.params, device=self.dev, **kw)

    def serve(self, name, be, sched, max_batch, simultaneous=False):
        """Serve one workload on ``be``."""
        if self.on_backend is not None:
            self.on_backend(name, be)
        rep = ServingEngine(be, sched, max_batch=max_batch).run(
            self.workload(simultaneous))
        if self.on_served is not None:
            self.on_served(name, be, rep)
        return rep

    def run(self, mode, chunk=None):
        be = self.backend(n_slots=N_SLOTS, max_len=MAX_LEN,
                          decode_mode="ar" if mode == "ar" else "elastic")
        if mode == "elastic":
            spec = CPU_HOST if self.dev.type == "cpu" else H100_SXM
            an = AnalyticDeviceModel(CFG, spec)
            samples = [(b, c, an.step_latency(b, c, 64))
                       for b in [1, 2, 4, 8] for c in [1, 2, 4, 8]]
            sch = ElasticScheduler.from_profile(samples, candidates=(2, 4, 8),
                                                prior_tokens_per_step=3.0)
        else:
            sch = FixedScheduler(1 if mode == "ar" else chunk)
        name = mode + (str(chunk) if chunk else "")
        rep = self.serve(name, be, sch, max_batch=8)
        total_steps = sum(m.decode_steps for m in rep.metrics)
        mean_chunk = np.mean([c for _, _, c in rep.chunk_history]) \
            if rep.chunk_history else 0
        print(f"{name:>10s}: "
              f"{rep.total_tokens} tokens, {total_steps} request-steps, "
              f"TU={rep.token_utilization:.3f}, "
              f"mean chunk={mean_chunk:.1f}")
        return {"tokens": rep.total_tokens, "request_steps": total_steps,
                "tu": rep.token_utilization, "mean_chunk": float(mean_chunk),
                "chunks": [int(c) for _, _, c in rep.chunk_history],
                "report": rep}

    def admission(self) -> dict:
        """Memory-elastic admission: requests claim prompt pages only, so
        the pool admits far more in flight than worst-case (prompt+out)
        reservation."""
        a = self.args
        total = a.prompt + a.out
        be = self.backend(n_slots=N_SLOTS, max_len=MAX_LEN)
        fit_worst = be.kv.n_pages // be.kv.pages_for(total)
        fit_prompt = be.kv.n_pages // be.kv.pages_for(a.prompt)
        rep = self.serve("admission", be, FixedScheduler(8), max_batch=64,
                         simultaneous=True)
        print(f"\nmemory-elastic admission: pool of {be.kv.n_pages} pages "
              f"fits {fit_prompt} prompts at admit (worst-case reservation: "
              f"{fit_worst}; dense-slot ceiling was {N_SLOTS}); peak "
              f"in-flight batch = {max(rep.batch_history)}, preemptions = "
              f"{rep.preemptions}")
        assert be.kv.free_pages == be.kv.n_pages     # drained: no page leaks
        out = {"n_pages": be.kv.n_pages, "fit_prompt": fit_prompt,
               "fit_worst": fit_worst, "peak_batch": max(rep.batch_history),
               "preemptions": rep.preemptions, "pages_for_total":
               be.kv.pages_for(total), "pages_for_prompt":
               be.kv.pages_for(a.prompt), "report": rep}
        return out

    def tight_pool(self, pages_for_total, pages_for_prompt) -> dict:
        """A pool sized so the whole workload cannot co-reside at full
        length: mid-decode OutOfPages forces evict+requeue+re-prefill, yet
        everyone still completes with full outputs."""
        a = self.args
        pages = max(2 * pages_for_total, 3 * pages_for_prompt)
        be = self.backend(max_len=MAX_LEN, kv_pages=pages)
        rep = self.serve("tight", be, FixedScheduler(8), max_batch=64,
                         simultaneous=True)
        done = sum(1 for m in rep.metrics if m.n_tokens == a.out)
        drained = be.kv.free_pages == be.kv.n_pages
        print(f"tight pool ({pages} pages): {done}/{a.requests} requests "
              f"completed full outputs with {rep.preemptions} preemptions; "
              f"pool drained clean = {drained}")
        return {"pages": pages, "completed": done,
                "preemptions": rep.preemptions, "drained": drained,
                "report": rep}


def settle(dev):
    """After a run: collect the finished backend (its hooks form reference
    cycles, and its graph cache holds its pool), then give the card back
    the allocator's cached blocks, before the next backend captures."""
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None, params=None, on_backend=None, on_served=None) -> dict:
    """Run the demo; ``params`` (a flat param dict, any device) serves
    those weights instead of drawing the seeded ones.  Returns each run's
    numbers (and its report, under "report")."""
    args = parse_args(argv)
    demo = Demo(args, params, on_backend, on_served)
    print(f"serving {args.requests} batched requests "
          f"(prompt {args.prompt}, output {args.out}) on a real model "
          f"[paged KV pool, incremental page growth]\n")
    out = {}
    for name, mode, chunk in (("ar", "ar", None), ("fixed8", "fixed", 8),
                              ("elastic", "elastic", None)):
        out[name] = demo.run(mode, chunk)
        settle(demo.dev)
    print("\nelastic runtime distributions:",
          chunk_distribution(out["elastic"]["report"]))
    out["admission"] = adm = demo.admission()
    settle(demo.dev)
    if args.tight_pool:
        out["tight"] = demo.tight_pool(adm["pages_for_total"],
                                       adm["pages_for_prompt"])
        settle(demo.dev)
    print("done — all requests completed through the continuous-batching "
          "engine")
    return out


if __name__ == "__main__":
    main()
