"""Plain reference of a block-diffusion LM served by streaming chunked
decoding (SDAR on a Qwen3-style dense trunk), in float32 with TF32 off.

It imports nothing of the program.  It is handed the weights (a dict keyed
by the checkpoint's names: ``embed``, ``blocks/pos0/{norm1,mixer,norm2,
ffn}/…`` stacked over layers, ``final_norm/scale``, ``lm_head``), the
prompts, and what the server committed: for each decode step of a request
the chunk size, the window positions committed and the tokens.  From those
alone it works out every window again — where it starts (the prompt plus
the tokens whose KV was frozen), how far it reaches (the chunk, clamped at
the block's end and at the output length), which positions held a token
at the step's input, and how many leading ones froze their KV — and runs
the model over the prompt (block-causal) and every window (its prefix
through the frozen KV, bidirectional inside the window's block), so the KV
a step reads is the KV that its earlier steps froze, computed here.

It also holds the server's commit decisions to the rule: a window slot
commits when its confidence (the softmax probability of its first-ranked
token) passes the threshold; a step where none passes commits its single
most confident slot.  Confidences are compared as log-odds, ``log(p / (1 -
p))``: the first-ranked logit less the log-sum-exp of all the others.

Layer by layer: all rows (the prompts and every window of every request)
go through one layer before the next, so each layer's weights are cast to
float32 once.  The caller gets, for each committed token, the logit it
scored here and the best logit at its position.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

UNSET = -1


@dataclass
class Served:
    """One served request: prompt ids, its decode steps as the server ran
    them [(chunk, commit mask over the window, valid)], and its tokens."""
    prompt: list
    steps: list
    tokens: list
    max_new: int


@dataclass
class Plan:
    """The rows of one request and how they attend."""
    tokens: list            # row token ids
    positions: list         # row absolute positions
    groups: list            # [(query rows, key rows, block-causal?)]
    scored: list            # [(row, served token)]
    faults: list            # departures of the served steps from the rules
    decisions: list         # each step's [(row, committed?)] over the
                            # window slots that held no token at its input


def plan(s: Served, block: int, mask_id: int) -> Plan:
    """The rows and attention groups of one served request, worked out from
    its prompt and commits alone."""
    L = len(s.prompt)
    toks, pos = list(s.prompt), list(range(L))
    groups = [(list(range(L)), list(range(L)), True)]
    kv_row = list(range(L))            # the row whose KV holds each position
    committed = [UNSET] * s.max_new
    frozen, faults, scored, decisions = 0, [], [], []
    for k, (c, mask, valid) in enumerate(s.steps):
        start = L + frozen
        blk_end = (start // block + 1) * block
        v = max(0, min(c, blk_end - start, s.max_new - frozen))
        if v != valid:
            faults.append(f"step {k}: valid {valid}, the rules give {v}")
        lo = len(toks)
        cai = []
        for i in range(v):
            t = committed[frozen + i]
            cai.append(t != UNSET)
            toks.append(t if t != UNSET else mask_id)
            pos.append(start + i)
        rows = list(range(lo, lo + v))
        groups.append((rows, kv_row[:start] + rows, False))
        hits = np.nonzero(np.asarray(mask, bool))[0]
        if len(hits) == 0 and not all(cai):
            faults.append(f"step {k}: nothing committed")
        hit = set(int(i) for i in hits)
        decisions.append([(lo + i, i in hit) for i in range(v)
                          if not cai[i]])
        for i in hits:
            i = int(i)
            if i >= v or cai[i]:
                faults.append(f"step {k}: commit at window slot {i}")
                continue
            tok = s.tokens[frozen + i] if frozen + i < len(s.tokens) else None
            if tok is None:
                faults.append(f"step {k}: commit past the served tokens")
                continue
            committed[frozen + i] = tok
            scored.append((lo + i, tok))
        n_adv = 0
        while n_adv < v and cai[n_adv]:
            n_adv += 1
        kv_row.extend(rows[:n_adv])
        frozen += n_adv
    if committed[:len(s.tokens)] != list(s.tokens):
        faults.append("the served tokens are not the committed ones")
    return Plan(toks, pos, groups, scored, faults, decisions)


def decision_errors(decisions: list, lodds: dict, threshold: float,
                    commits=None) -> tuple[list, list]:
    """How far each commit decision lies on the wrong side of the threshold,
    in log-odds read from ``lodds`` (row → log-odds); negative on the right
    side.  ``(commits, skips)``: one entry a committed slot, leaving out a
    step's only commit (the rule's progress commit, or one that passed),
    and one a slot left uncommitted.  ``commits`` (row → committed?)
    replaces the served decisions, for the control."""
    t = float(np.log(threshold / (1.0 - threshold)))
    hit, miss = [], []
    for step in decisions:
        done = [(r, c if commits is None else commits[r]) for r, c in step]
        hits = [r for r, c in done if c]
        if len(hits) > 1:
            hit += [t - lodds[r] for r in hits]
        miss += [lodds[r] - t for r, c in done if not c]
    return hit, miss


def rule_commits(decisions: list, lodds: dict, threshold: float) -> dict:
    """row → committed?, by the rule, on confidences ``lodds``."""
    t = float(np.log(threshold / (1.0 - threshold)))
    out = {}
    for step in decisions:
        rows = [r for r, _ in step]
        if not rows:
            continue
        hits = {r for r in rows if lodds[r] > t}
        if not hits:
            hits = {max(rows, key=lambda r: lodds[r])}
        out.update((r, r in hits) for r in rows)
    return out


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax to 448), back in float32: the control's precision."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Linear:
    def __init__(self, w: torch.Tensor, precision: str):
        self.w = w.to(torch.float32)
        self.fp8 = precision == "fp8"
        if self.fp8:
            self.w = _fp8(self.w, 0)           # a scale per output column

    def __call__(self, x):
        if self.fp8:
            x = _fp8(x, -1)                    # a scale per input row
        return x @ self.w


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """Split-half rotary embedding of x [N, heads, D] at ``positions``."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = positions.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, causal_pos, block):
    """q [Tq, H, D], k/v [Tk, KVH, D] → [Tq, H·D]; with ``causal_pos`` (the
    rows' positions, queries = keys) a block-causal mask."""
    Tq, H, D = q.shape
    KVH = k.shape[1]
    g = H // KVH
    qg = q.view(Tq, KVH, g, D)
    s = torch.einsum("qkgd,tkd->kgqt", qg, k) / float(np.sqrt(D))
    if causal_pos is not None:
        b = torch.div(causal_pos, block, rounding_mode="floor")
        s = s.masked_fill(~(b[None, :] <= b[:, None]), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("kgqt,tkd->qkgd", p, v).reshape(Tq, H * D)


def score(weights: dict, arch: dict, plans: list, *, device,
          precision: str = "fp32", gain_key: str = "final_norm/scale",
          extra=None, row_block: int = 2048):
    """Run every plan's rows through the model.  Returns, for each scored
    row in plan order, ``(best logit, served token's logit, argmax,
    extra token's logit)`` (``extra``: one more token a scored row, whose
    logit to report; None reports nan); and for each plan a dict of the
    log-odds of its decision rows' confidences (plan row → log-odds)."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _score(weights, arch, plans, device, precision, gain_key,
                      extra, row_block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = was


@torch.no_grad()
def _score(weights, arch, plans, device, precision, gain_key, extra,
           row_block):
    H, KVH, D = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    eps, theta, block = arch["norm_eps"], arch["rope_theta"], \
        arch["block_size"]
    base, groups, scored, judged = [], [], [], []
    toks, pos = [], []
    for p in plans:
        off = len(toks)
        base.append(off)
        toks += p.tokens
        pos += p.positions
        for qr, kr, causal in p.groups:
            groups.append((torch.tensor([off + r for r in qr], device=device),
                           torch.tensor([off + r for r in kr], device=device),
                           causal))
        scored += [(off + r, t) for r, t in p.scored]
        judged += [(len(base) - 1, r) for step in p.decisions
                   for r, _ in step]
    tok_t = torch.tensor(toks, device=device)
    pos_t = torch.tensor(pos, device=device)
    x = weights["embed"][tok_t].to(torch.float32)
    n_layers = weights["blocks/pos0/norm1/scale"].shape[0]
    pre = "blocks/pos0/"
    for l in range(n_layers):
        w = {n[len(pre):]: t[l] for n, t in weights.items()
             if n.startswith(pre)}
        lin = {n: _Linear(w[f"mixer/{n}"], precision)
               for n in ("wq", "wk", "wv", "wo")}
        h = _rms(x, w["norm1/scale"].float(), eps)
        q = _rope(lin["wq"](h).view(-1, H, D), pos_t, theta)
        k = _rope(lin["wk"](h).view(-1, KVH, D), pos_t, theta)
        v = lin["wv"](h).view(-1, KVH, D)
        att = torch.empty(x.shape[0], H * D, device=device)
        for qr, kr, causal in groups:
            att[qr] = _attend(q[qr], k[kr], v[kr],
                              pos_t[qr] if causal else None, block)
        x = x + lin["wo"](att)
        del lin, q, k, v, att
        up, gate, down = (_Linear(w[f"ffn/{n}"], precision)
                          for n in ("w_up", "w_gate", "w_down"))
        for lo in range(0, x.shape[0], row_block):
            h = _rms(x[lo:lo + row_block], w["norm2/scale"].float(), eps)
            x[lo:lo + row_block] += down(torch.nn.functional.silu(gate(h))
                                         * up(h))
        del up, gate, down
    head = _Linear(weights["lm_head"], precision)
    fin = weights[gain_key].float()
    out = []
    rows = [r for r, _ in scored]
    for lo in range(0, len(rows), row_block):
        idx = torch.tensor(rows[lo:lo + row_block], device=device)
        logits = head(_rms(x[idx], fin, eps))
        best, arg = logits.max(-1)
        tt = torch.tensor([t for _, t in scored[lo:lo + row_block]],
                          device=device)
        mine = logits.gather(1, tt[:, None])[:, 0]
        if extra is not None:
            et = torch.tensor(extra[lo:lo + row_block], device=device)
            ex = logits.gather(1, et[:, None])[:, 0]
        else:
            ex = torch.full_like(mine, float("nan"))
        out += list(zip(best.tolist(), mine.tolist(), arg.tolist(),
                        ex.tolist()))
        del logits
    lodds = [{} for _ in plans]
    for lo in range(0, len(judged), row_block):
        part = judged[lo:lo + row_block]
        idx = torch.tensor([base[k] + r for k, r in part], device=device)
        logits = head(_rms(x[idx], fin, eps))
        best, arg = logits.max(-1)
        logits.scatter_(1, arg[:, None], float("-inf"))
        odds = best - torch.logsumexp(logits, -1)
        for (k, r), v in zip(part, odds.tolist()):
            lodds[k][r] = v
        del logits
    return out, lodds


def judge(weights: dict, arch: dict, served: list, *, device,
          control: bool = False) -> dict:
    """Hold the served requests to the model.

    ``gap``: the widest amount by which a served token's logit lies below
    the best logit at its position (0 where the server took the argmax);
    ``faults``: served steps that break the decoding rules; ``tokens``:
    tokens judged; ``flips``: served tokens that are not the argmax here;
    ``commit_shortfall``, ``skip_excess``: the commit decisions read
    against the threshold, the worst of each side, 0 where none lies on
    the wrong side (:func:`decision_errors`);
    ``decision_error``: the mean over every decision read of how far it
    lies on the wrong side (0 on the right side); ``decisions``: how many
    were read, how many lie on the wrong side, and by how much in all.  ``control``: the same prompts and
    commits, the model in float8 put in the server's place — its gap is
    that of the token it ranks first, its decisions those the rule makes
    on its own confidences."""
    plans = [plan(s, arch["block_size"], arch["mask_token_id"])
             for s in served]
    faults = [f for p in plans for f in p.faults]
    th = arch["confidence_threshold"]
    if control:
        low, low_odds = score(weights, arch, plans, device=device,
                              precision="fp8")
        out, odds = score(weights, arch, plans, device=device,
                          extra=[a for _, _, a, _ in low])
        gaps = [b - e for b, _, _, e in out]
        errs = [decision_errors(p.decisions, o, th,
                                rule_commits(p.decisions, lo, th))
                for p, o, lo in zip(plans, odds, low_odds)]
    else:
        out, odds = score(weights, arch, plans, device=device)
        gaps = [b - m for b, m, _, _ in out]
        errs = [decision_errors(p.decisions, o, th)
                for p, o in zip(plans, odds)]
    flips = sum(1 for (b, m, a, _), p in zip(
        out, [t for pl in plans for _, t in pl.scored]) if a != p)
    hit = [e for h, _ in errs for e in h]
    miss = [e for _, m in errs for e in m]
    wrong = [max(0.0, e) for e in hit + miss]
    return {"gap": max(gaps) if gaps else float("nan"),
            "faults": faults, "tokens": len(gaps), "flips": flips,
            "commit_shortfall": max([0.0] + hit),
            "skip_excess": max([0.0] + miss),
            "decision_error": sum(wrong) / max(1, len(wrong)),
            "decisions": {"commits": len(hit), "skips": len(miss),
                          "wrong_commits": sum(e > 0 for e in hit),
                          "wrong_skips": sum(e > 0 for e in miss),
                          "commit_mass": sum(max(0.0, e) for e in hit),
                          "skip_mass": sum(max(0.0, e) for e in miss)}}
