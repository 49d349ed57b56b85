"""Whether what the timed path served is correct.

After the window has closed and the program's state is freed, a sample of
the requests the run finished — the longest, then others drawn from the
seed until some hundreds of tokens are in it — goes to the configuration's
plain reference (``bench/reference/<reference>.py``), which is handed the
same weights and prompts and what the server committed, and works out
everything else itself.  Each number it returns is held to the limit the
configuration's ``check`` gives it (see PERF.md for the readings each
limit was set from).
"""

from __future__ import annotations

import importlib

from harness.traffic import rng_for


def sample(outputs: dict, arrivals: list, seed: int, min_tokens: int,
           max_requests: int) -> list:
    """rids of finished requests: the longest served, then others in an
    order drawn from the seed, until ``min_tokens`` tokens or
    ``max_requests`` requests."""
    done = sorted(outputs, key=lambda r: (-len(outputs[r]), r))
    if not done:
        return []
    picked = [done[0]]
    rest = list(rng_for(seed, 3).permutation(done[1:]))
    n = len(outputs[done[0]])
    for r in rest:
        if n >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(int(r))
        n += len(outputs[r])
    return picked


def served(rec, arrivals: list, rids: list) -> list:
    from reference.block_diffusion_lm import Served
    by_rid = {a.rid: a for a in arrivals}
    return [Served(list(by_rid[r].prompt), rec.steps.get(r, []),
                   rec.outputs[r], by_rid[r].max_new) for r in rids]


def judge(config: dict, weights: dict, items: list, device,
          control: bool = False, **kw) -> dict:
    ref = importlib.import_module(f"reference.{config['reference']}")
    return ref.judge(weights, config["arch"], items, device=device,
                     control=control, **kw)


def verdict(config: dict, result: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "rule", "limit"}}) for a reference's
    result.  Every number the configuration gives a limit for is held to
    it; a limit left null holds nothing to be correct (a cell whose limit
    has not been set from readings), and a missing or nan reading fails."""
    lim = config["check"]
    checked = {"logit_gap": (result["gap"], "<=", lim["logit_gap"]),
               "step_faults": (len(result["faults"]), "<=", 0)}
    if "decision_error" in lim:
        checked["decision_error"] = (result.get("decision_error"), "<=",
                                     lim["decision_error"])
    checked["tokens_judged"] = (result["tokens"], ">=", lim["min_tokens"])
    ok = True
    for value, rule, limit in checked.values():
        if value is None or limit is None or value != value:
            ok = False
        elif not (value <= limit if rule == "<=" else value >= limit):
            ok = False
    return ok, {n: {"value": v, "rule": r, "limit": li}
                for n, (v, r, li) in checked.items()}
