"""The calibration readings of ``bench/calibrate.py``, on one system built
once: the gain's bisection, the knee sweep, and the correctness readings
of the program and of its control over many seeds."""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from harness import check, serve, weights
from harness.runner import Run, load_reader, model_shape, readings_of
from harness.spec import Cell
from harness.traffic import Arrival, lognormal_quantiles, make_arrivals

METRICS = ("tokens_per_s", "ttft_p90_ms", "tpot_p90_ms", "queue_wait_p90_ms",
           "prefill_tokens_per_tick", "token_utilization", "decode_step_ms",
           "model_mfu", "graph_captures_in_window")


def _numbers(res: dict) -> dict:
    """A reference's readings, as ``check.verdict`` compares them."""
    keys = ("gap", "flips", "tokens", "commit_shortfall", "skip_excess",
            "decision_error", "decisions")
    return {k: res[k] for k in keys if k in res}


class System:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, emit):
        from repro_torch.serving.clock import WallClock
        self.cfg, self.mix, self.emit = cfg, mix, emit
        self.dev = torch.device(device)
        t = time.perf_counter()
        self.model = serve.build_model(cfg)
        self.layout = self.model.init_params(device="meta")
        self.params, self.bufs = weights.draw(self.layout, cfg, seed,
                                              self.dev)
        self.backend = serve.build_backend(self.model, self.params, cfg,
                                           self.dev)
        t_built = time.perf_counter() - t
        ticks = serve.warm_up(self.backend, cfg, WallClock())
        cuda = self.dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.dev)
        self.setup = {
            "build_s": t_built, "warm_s": time.perf_counter() - t - t_built,
            "warm_ticks": ticks, "graphs": serve.graph_count(self.backend),
            "kv_pages": cfg["serve"].get("kv_pages"),
            "allocated": torch.cuda.memory_allocated(self.dev) if cuda else 0,
            "peak": torch.cuda.max_memory_allocated(self.dev) if cuda else 0,
            "device": serve.device_name(self.dev),
            "gain": cfg.get("final_norm_gain", 1.0),
            "keys": self.keys()}
        self.shape = model_shape(self.model, self.layout, cfg)

    def keys(self) -> list:
        g = self.backend.graphs
        return [] if g is None else [str(k[:2]) for k in g.entries]

    def redraw(self, seed: int):
        self.params, self.bufs = weights.draw(self.layout, self.cfg, seed,
                                              self.dev, self.bufs)

    def _engine(self, sched, rec, clock):
        return serve.engine(serve.BackendProbe(self.backend, rec, clock),
                            serve.SchedulerProbe(sched, rec, clock),
                            self.cfg, clock)

    def _clear(self, core):
        for r in core.active_requests():
            self.backend.release(r.rid)

    # -- the gain --------------------------------------------------------
    def bisect_gain(self, n_req: int = 16, max_new: int = 128,
                    steps: int = 10, lo: float = 0.5, hi: float = 512.0):
        """Log-bisect the final norm's gain so that bd32 decoding commits
        the mix's ``tokens_per_step_bd32`` tokens a request a dispatch."""
        from repro_torch.core.scheduler import scheduler_for_mode
        from repro_torch.serving.clock import WallClock
        target = self.mix["tokens_per_step_bd32"]
        p = self.mix["prompt"]
        lens = lognormal_quantiles(p["mean"], p["std"], n_req, p["min"],
                                   p["max"])
        rng = np.random.default_rng(7)
        vocab = self.model.cfg.vocab_size
        room = self.cfg["serve"]["max_len"]
        reqs = [Arrival(10 ** 8 + i, 0.0,
                        tuple(int(x) for x in rng.integers(4, vocab, n)),
                        min(max_new, room - int(n)))
                for i, n in enumerate(lens)]
        scale = self.params["final_norm/scale"]

        def rate(g):
            scale.fill_(g)
            rec, clock = serve.Record(), WallClock()
            core = self._engine(scheduler_for_mode("bd32"), rec, clock)
            for a in reqs:
                core.submit(serve.request(a))
            core.drain()
            per = [int(m.sum()) for st in rec.steps.values()
                   for _, m, _ in st]
            return float(np.mean(per)), per

        for _ in range(steps):
            g = math.sqrt(lo * hi)
            r, per = rate(g)
            self.emit({"gain": g, "tokens_per_step": r, "target": target})
            if r < target:
                lo = g
            else:
                hi = g
        g = math.sqrt(lo * hi)
        r, per = rate(g)
        hist = np.bincount(per, minlength=33).tolist()
        self.emit({"gain_final": g, "tokens_per_step": r, "target": target,
                   "commits_hist": hist, "steps": len(per)})
        self.cfg["final_norm_gain"] = g          # later modes and redraws

    @torch.no_grad()
    def forward_gap(self, items) -> dict:
        """The served tokens read against the program's own unpadded full
        forward (``model.apply`` over prompt and tokens): another path of
        the program, as a witness for an AR cell."""
        gaps, flips = [], 0
        for s in items:
            seq = torch.tensor([list(s.prompt) + list(s.tokens)],
                               device=self.dev)
            lg = self.model.apply(self.params, seq)[0]
            at = torch.arange(len(s.prompt) - 1,
                              len(s.prompt) - 1 + len(s.tokens),
                              device=self.dev)
            want = torch.tensor(list(s.tokens), device=self.dev)
            rows = lg[at]
            best, arg = rows.max(-1)
            gaps += (best - rows.gather(1, want[:, None])[:, 0]).tolist()
            flips += int((arg != want).sum())
        return {"gap": max(gaps), "flips": flips}

    # -- serving at a rate -----------------------------------------------
    def serve(self, rate: float, seed: int, seconds: float, judge: bool,
              control: bool = False):
        from repro_torch.serving.clock import WallClock
        mix = dict(self.mix, arrivals=dict(self.mix["arrivals"], rate=rate))
        preroll = mix["preroll_s"]
        arrivals = make_arrivals(mix, seed, preroll + seconds + 5.0,
                                 self.model.cfg.vocab_size)
        rec, clock = serve.Record(), WallClock()
        core = self._engine(serve.build_scheduler(self.model, self.cfg, mix),
                            rec, clock)
        gc.collect()
        nxt = serve.drive(core, arrivals, clock, preroll, rec)
        w0 = clock.now()
        g0 = serve.graph_count(self.backend)
        serve.drive(core, arrivals, clock, w0 + seconds, rec, start=nxt)
        g1 = serve.graph_count(self.backend)
        cell = Cell("calibration", self.cfg, mix)
        r = Run(cell, arrivals, rec, w0, w0 + seconds, 0.0,
                None if g0 is None else (g0, g1), None, self.shape,
                {"preemptions": core.preemptions,
                 "kv_pages": self.backend.kv.n_pages
                 if self.backend.paged else None})
        line = {"rate": rate, "seed": seed, "graph_keys": self.keys(),
                "metrics": {m: load_reader(m)(r) for m in METRICS},
                "readings": readings_of(r)}
        self._clear(core)
        del core
        if judge:
            ck = self.cfg["check"]
            rids = check.sample(rec.outputs, arrivals, seed,
                                ck["sample_tokens"], ck["sample_requests"])
            items = check.served(rec, arrivals, rids)
            t = time.perf_counter()
            res = check.judge(self.cfg, self.params, items, self.dev)
            line["program"] = {**_numbers(res), "faults": res["faults"][:5],
                               "seconds": time.perf_counter() - t}
            if control:
                t = time.perf_counter()
                c = check.judge(self.cfg, self.params, items, self.dev,
                                control=True)
                line["control"] = {**_numbers(c),
                                   "seconds": time.perf_counter() - t}
            if "witness" in ck:
                w = check.judge(self.cfg, self.params, items, self.dev,
                                **ck["witness"])
                line["witness"] = {"gap": w["gap"], "flips": w["flips"]}
                line["program_forward"] = self.forward_gap(items)
        self.emit(line)
