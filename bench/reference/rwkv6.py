"""Plain reference of an RWKV6 ("Finch") LM served autoregressively, in
float32 with TF32 off.

It imports nothing of the program.  The weights come as a dict keyed by
the checkpoint's names (``embed``, ``blocks/pos0/{norm1,norm2}/scale``,
``blocks/pos0/mixer/{mu,wr,wk,wv,wg,w0,w_lora_a,w_lora_b,bonus_u,
ln_scale,wo}``, ``blocks/pos0/ffn/{mu,wk,wv,wr}``, stacked over layers,
``final_norm/scale``, ``lm_head``).  The trunk is the repository's RWKV6:
RMSNorm before each mixer; time-mix with token shift, data-dependent decay
``exp(-exp(w0 + tanh(x·A)·B))``, the bonus ``u`` and a per-head group norm
scaled by ``1 + ln_scale``; channel-mix ``sigmoid(r)·(relu(k)²·V)``.

A served request is its prompt and its greedy tokens: token ``i`` was
chosen from the logits after the prompt and tokens ``< i``.  ``judge`` runs
the whole sequence once and reads, at each token's position, how far its
logit lies below the best.  ``pad_to`` runs the prompt padded with id 0 to
that length before the tokens, as a server that prefills a fixed-length
slot would (a reading of where a departure comes from, not a check).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.block_diffusion_lm import _fp8


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _lin(x, w, fp8: bool):
    w = w.float()
    if fp8:
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _shift(x, prev):
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


@torch.no_grad()
def forward(weights: dict, arch: dict, tokens: torch.Tensor,
            fp8: bool = False) -> torch.Tensor:
    """Final hidden states [B, T, d] (before the final norm) of ``tokens``
    [B, T] from zero states."""
    d, hd = arch["d_model"], arch["rwkv_head_dim"]
    hn = d // hd
    eps = arch["norm_eps"]
    B, T = tokens.shape
    x = weights["embed"][tokens].float()
    L = weights["blocks/pos0/norm1/scale"].shape[0]
    for l in range(L):
        w = {n[len("blocks/pos0/"):]: t[l].float()
             for n, t in weights.items() if n.startswith("blocks/pos0/")}
        h = _rms(x, w["norm1/scale"], eps)
        zero = torch.zeros(B, d, device=x.device)
        prev = _shift(h, zero)
        mu = w["mixer/mu"]
        xr, xk, xv, xg, xw = (h + (prev - h) * mu[i] for i in range(5))
        r = _lin(xr, w["mixer/wr"], fp8).view(B, T, hn, hd)
        k = _lin(xk, w["mixer/wk"], fp8).view(B, T, hn, hd)
        v = _lin(xv, w["mixer/wv"], fp8).view(B, T, hn, hd)
        g = F.silu(_lin(xg, w["mixer/wg"], fp8))
        dec = w["mixer/w0"] + _lin(torch.tanh(_lin(xw, w["mixer/w_lora_a"],
                                                   fp8)),
                                   w["mixer/w_lora_b"], fp8)
        dec = torch.exp(-torch.exp(dec)).view(B, T, hn, hd)
        u = w["mixer/bonus_u"]
        S = torch.zeros(B, hn, hd, hd, device=x.device)
        ys = []
        for t in range(T):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                   S + u[:, :, None] * kv))
            S = dec[:, t, :, :, None] * S + kv
        y = torch.stack(ys, 1)
        mean = y.mean(-1, keepdim=True)
        var = y.var(-1, keepdim=True, unbiased=False)
        y = ((y - mean) * torch.rsqrt(var + 1e-5)
             * (1.0 + w["mixer/ln_scale"]).view(hn, hd)).reshape(B, T, d)
        x = x + _lin(y * g, w["mixer/wo"], fp8)
        h = _rms(x, w["norm2/scale"], eps)
        prev = _shift(h, zero)
        mu = w["ffn/mu"]
        xk = h + (prev - h) * mu[0]
        xr = h + (prev - h) * mu[1]
        kk = torch.square(torch.relu(_lin(xk, w["ffn/wk"], fp8)))
        x = x + torch.sigmoid(_lin(xr, w["ffn/wr"], fp8)) * _lin(
            kk, w["ffn/wv"], fp8)
    return x


def judge(weights: dict, arch: dict, served: list, *, device,
          control: bool = False, pad_to: int | None = None) -> dict:
    """``gap``: the widest amount by which a served token's logit lies below
    the best at its position; ``tokens``: tokens judged; ``flips``: served
    tokens that are not the argmax here; ``faults``: none (an AR step has
    no rule of its own to break).  ``control``: the model in float8 in the
    server's place (its gap is that of the token it ranks first)."""
    was = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        seqs, reads = [], []
        for s in served:
            pad = [0] * (pad_to - len(s.prompt)) if pad_to else []
            seq = list(s.prompt) + pad + list(s.tokens)
            first = len(s.prompt) + len(pad)
            # token i is read at the position before it; the first at the
            # prompt's last position (the padding comes after it)
            at = [len(s.prompt) - 1] + [first + i for i in
                                        range(len(s.tokens) - 1)]
            seqs.append(seq)
            reads.append((at, list(s.tokens)))
        T = max(len(q) for q in seqs)
        toks = torch.tensor([q + [0] * (T - len(q)) for q in seqs],
                            device=device)
        fin = weights["final_norm/scale"].float()
        eps = arch["norm_eps"]

        def logits_at(x, b, at):
            return _lin(_rms(x[b, at], fin, eps), weights["lm_head"],
                        False)

        x = forward(weights, arch, toks)
        xl = forward(weights, arch, toks, fp8=True) if control else None
        gaps, flips = [], 0
        for b, (at, want) in enumerate(reads):
            lg = logits_at(x, b, at)
            best, arg = lg.max(-1)
            pick = torch.tensor(want, device=device)
            if control:
                pick = _lin(_rms(xl[b, at], fin, eps), weights["lm_head"],
                            True).argmax(-1)
            mine = lg.gather(1, pick[:, None])[:, 0]
            gaps += (best - mine).tolist()
            flips += int((arg != torch.tensor(want, device=device)).sum())
        return {"gap": max(gaps) if gaps else float("nan"), "faults": [],
                "tokens": len(gaps), "flips": flips}
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = was
