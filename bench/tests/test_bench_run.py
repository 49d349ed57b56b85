"""CPU rehearsals of a whole run at the SMOKE sizes, past the harness's
look for a card: the sound program comes out correct; the same run with
the timed path broken underneath comes out not correct, once for each
fault a served cell can have (a step that leaves its state unchanged, half
of the batch left out, a token altered where it is produced; one card has
no exchange between chips) and for commit decisions off the threshold
(every slot committed, the threshold lowered or raised); the control — the reference in float8 in the
program's place — reads far above the program; and the recurrent slot
path's inherited padded prefill is caught."""

import json
import time
from pathlib import Path

import pytest
import torch

from harness import check, runner
from harness.spec import Cell

DATA = Path(__file__).resolve().parent / "data"
E2E = [{"name": n, "unit": u} for n, u in
       (("tokens_per_s", "tokens/s"), ("ttft_p90_ms", "ms"),
        ("tpot_p90_ms", "ms"), ("setup_s", "s"))]
LAYER = [{"name": n, "unit": "x"} for n in
         ("queue_wait_p90_ms", "prefill_tokens_per_tick", "token_utilization",
          "decode_step_ms", "model_mfu", "graph_captures_in_window",
          "slot_prefill_ms")]


def _cell(config, traffic, rate=None):
    cfg = json.loads((DATA / f"{config}.json").read_text())
    mix = json.loads((DATA / f"{traffic}.json").read_text())
    if rate is not None:
        mix["arrivals"]["rate"] = rate
    return Cell("smoke", cfg, mix, E2E, LAYER)


def _run(cell, seed=2 ** 33 + 1, seconds=3.0, trace=False):
    return runner.run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                      log=lambda s: None)


def test_sound_run_is_correct_and_reports_every_metric():
    out = _run(_cell("sdar-smoke", "small-poisson"))
    assert out["correct"], out["checked"]
    assert set(out["metrics"]) == {m["name"] for m in E2E}
    assert out["metrics"]["tokens_per_s"]["value"] > 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checked"
    traced = _run(_cell("sdar-smoke", "small-poisson"), trace=True)
    assert {"queue_wait_p90_ms", "token_utilization",
            "decode_step_ms"} <= set(traced["metrics"])


def _freeze_nothing(self, cache, *a, **k):
    return cache


def _half_batch(orig):
    def fn(self, *a, **k):
        conf, tok, cache = orig(self, *a, **k)
        h = tok.shape[0] // 2
        if h:
            conf, tok = conf.clone(), tok.clone()
            conf[h:2 * h], tok[h:2 * h] = conf[:h], tok[:h]
        return conf, tok, cache
    return fn


def _alter_token(orig):
    def fn(logits):
        conf, tok = orig(logits)
        tok = tok.clone()
        tok[..., 0] = (tok[..., 0] + 1) % logits.shape[-1]
        return conf, tok
    return fn


def _threshold(orig, moved):
    def fn(conf, uncommitted, thresholds):
        return orig(conf, uncommitted, moved(thresholds))
    return fn


THRESHOLDS = {"commit_all": lambda th: th * 0 - 1.0,
              "threshold_lowered": lambda th: th - 0.3,
              "threshold_raised": lambda th: th * 0 + 0.99}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered", *THRESHOLDS])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core import chunked
    from repro_torch.models import transformer
    TL = transformer.TransformerLM
    if fault in THRESHOLDS:
        monkeypatch.setattr(chunked, "batch_commit_decisions",
                            _threshold(chunked.batch_commit_decisions,
                                       THRESHOLDS[fault]))
    elif fault == "state_unchanged":
        monkeypatch.setattr(TL, "freeze_paged", _freeze_nothing)
    elif fault == "half_batch":
        monkeypatch.setattr(TL, "decode_step_paged",
                            _half_batch(TL.decode_step_paged))
    else:
        monkeypatch.setattr(transformer, "softmax_confidence_device",
                            _alter_token(
                                transformer.softmax_confidence_device))
    out = _run(_cell("sdar-smoke", "small-poisson", rate=30.0), seconds=2.5)
    assert not out["correct"], out["checked"]
    if fault in THRESHOLDS:             # the decisions, not the tokens, fail
        c = out["checked"]
        assert c["logit_gap"]["value"] <= c["logit_gap"]["limit"]
        assert c["decision_error"]["value"] > c["decision_error"]["limit"]


def test_control_reads_far_above_the_program():
    """The control (the reference in float8 in the program's place) fails
    the limit the sound program meets, on the same prompts and commits."""
    from harness import serve, weights
    from harness.serve import BackendProbe, Record
    from harness.traffic import make_arrivals
    from repro_torch.serving.clock import WallClock
    cell = _cell("sdar-smoke", "small-poisson")
    cfg = cell.config
    model = serve.build_model(cfg)
    params, _ = weights.draw(model.init_params(device="meta"), cfg, 5, "cpu")
    backend = serve.build_backend(model, params, cfg, "cpu")
    rec, clock = Record(), WallClock()
    core = serve.engine(BackendProbe(backend, rec, clock),
                        serve.build_scheduler(model, cfg, cell.traffic), cfg,
                        clock)
    arr = make_arrivals(cell.traffic, 5, 2.0, model.cfg.vocab_size)
    for a in arr:
        core.submit(serve.request(a))
    core.drain()
    ck = cfg["check"]
    items = check.served(rec, arr, check.sample(
        rec.outputs, arr, 5, ck["sample_tokens"], ck["sample_requests"]))
    prog = check.judge(cfg, params, items, torch.device("cpu"))
    ctl = check.judge(cfg, params, items, torch.device("cpu"), control=True)
    assert prog["gap"] <= ck["logit_gap"] < ctl["gap"]
    assert ctl["gap"] >= 3 * max(prog["gap"], ck["logit_gap"] / 3)
    assert prog["decision_error"] <= ck["decision_error"]
    assert prog["decisions"]["skips"] + prog["decisions"]["commits"] > 0


def test_padded_slot_prefill_is_caught():
    """RWKV6 on the slot path: the states run over the prompt's padding, so
    the served tokens after the first depart from the plain model; once the
    reference runs the same padding they agree."""
    out = _run(_cell("rwkv6-smoke", "small-bursty"), seconds=2.0)
    assert not out["correct"]
    assert out["checked"]["logit_gap"]["value"] > 1.0
