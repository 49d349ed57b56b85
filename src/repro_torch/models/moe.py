"""Mixture-of-Experts FFN, on one device (no expert parallelism).

The counterpart of the JAX package's ``models/moe.py`` with the same
semantics, dtypes and rounding points:

* :func:`moe_block_dense` — one-hot einsum over every expert (the oracle;
  also what every config with at most 8 experts runs, as in the reference
  when no mesh is installed).
* :func:`_moe_local` — the sorted production path on one device
  (``n_model = 1``): token-choice top-k routing, the (token, expert) pairs
  sorted by expert with a stable argsort and cut to the capacity, one
  grouped product per weight (:func:`grouped_matmul`, the counterpart of
  ``lax.ragged_dot``), gates applied in fp32 and the pairs scatter-added
  back into an fp32 ``y``.  With one device every expert is local, so the
  reference's ``is_local`` mask is all true and is left out here.

:func:`grouped_matmul` keeps the group sizes on the device: on a CUDA
tensor it is one ``torch._grouped_mm`` call (bf16 only; anything else
raises rather than falling back, since the fallback would read the sizes
on the host), on a CPU tensor the plain loop over the groups
(:func:`grouped_matmul_loop`).  The port has a mesh
(:mod:`repro_torch.launch.mesh`, with the collectives of
:mod:`repro_torch.distributed`), but expert parallelism over it
(``moe_block_sharded`` / ``moe_block_2d``) is not ported yet.

``GROUPED_CALLS`` counts grouped products that went through the CUDA
route, so a run can show that its MoE layers did.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ArchConfig, dense_init
from repro_torch.models.layers import _act

GROUPED_CALLS = 0


def _stacked_init(gen, shape, dtype, device, fan_in: int):
    """``dense_init`` of a ``[n, …]`` stack drawn one layer at a time into a
    tensor of ``dtype``, so the fp32 draw never holds more than one layer's
    slice (an expert stack is GBs a layer at full width)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if torch.device(device).type != "meta":
        for l in range(shape[0]):
            out[l] = dense_init(gen, shape[1:], dtype, device, fan_in=fan_in)
    return out


def init_moe(gen, cfg: ArchConfig, device, n: int):
    """Router ``[n, d, E]`` and expert weights ``w_gate``/``w_up``
    ``[n, E, d, f]``, ``w_down`` ``[n, E, f, d]``."""
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    pd = cfg.pdt
    return {
        "router": dense_init(gen, (n, d, e), pd, device, fan_in=d),
        "w_gate": _stacked_init(gen, (n, e, d, f), pd, device, fan_in=d),
        "w_up": _stacked_init(gen, (n, e, d, f), pd, device, fan_in=d),
        "w_down": _stacked_init(gen, (n, e, f, d), pd, device, fan_in=f),
    }


def _route(x, router_w, top_k: int):
    """x [T,d] → (gates [T,k] fp32, ids [T,k] int32); gates renormalised."""
    logits = (x @ router_w.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert id, as lax.top_k: bf16 logits tie
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :top_k], ids[..., :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids.to(torch.int32)


# ---------------------------------------------------------------------------
# Oracle path
# ---------------------------------------------------------------------------

def moe_block_dense(p, cfg: ArchConfig, x):
    """Reference MoE: [B,T,d] → [B,T,d] computing every expert densely."""
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    gates, ids = _route(xf, p["router"], cfg.top_k)
    act = _act(cfg.act)
    cd = cfg.cdt
    h = torch.einsum("td,edf->tef", xf, p["w_gate"].to(cd))
    u = torch.einsum("td,edf->tef", xf, p["w_up"].to(cd))
    o = torch.einsum("tef,efd->ted", act(h) * u, p["w_down"].to(cd))
    onehot = torch.nn.functional.one_hot(ids.long(), cfg.n_experts).float()
    combine = torch.einsum("tke,tk->te", onehot, gates)           # [T,E]
    out = torch.einsum("ted,te->td", o.float(), combine)
    return out.reshape(B, T, d).to(x.dtype)


# ---------------------------------------------------------------------------
# Production path
# ---------------------------------------------------------------------------

def grouped_matmul_loop(rows, w, group_sizes):
    """The plain grouped product: rows ``[M,K]`` cut into consecutive groups
    of ``group_sizes[e]`` rows, group ``e`` times ``w[e]`` ``[K,N]``; rows
    past the groups come out 0 (``lax.ragged_dot``).  Reads the sizes on
    the host."""
    out = rows.new_zeros((rows.shape[0], w.shape[-1]))
    lo = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[lo:lo + n] = rows[lo:lo + n] @ w[e]
        lo += n
    return out


def grouped_matmul(rows, w, group_sizes):
    """``lax.ragged_dot(rows, w, group_sizes)``.  A CUDA tensor runs one
    ``torch._grouped_mm`` with int32 end offsets computed on the device (no
    host read; bf16 only, anything else raises); a CPU tensor runs
    :func:`grouped_matmul_loop`."""
    global GROUPED_CALLS
    if not rows.is_cuda:
        return grouped_matmul_loop(rows, w, group_sizes)
    if rows.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"grouped_matmul on CUDA takes bfloat16 (got "
                         f"{rows.dtype} rows, {w.dtype} weights)")
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    out = torch._grouped_mm(rows, w, offs=offs)
    GROUPED_CALLS += 1
    # rows past the last group are left unwritten by the library call
    live = torch.arange(rows.shape[0], device=rows.device) < offs[-1]
    return torch.where(live[:, None], out, 0)


def capacity(T: int, k: int, capacity_factor: float) -> int:
    """(token, expert) pairs kept: ``ceil(T·k·cf)`` clamped to [1, T·k];
    ``cf <= 0`` keeps all."""
    if capacity_factor > 0:
        C = int(np.ceil(T * k * capacity_factor))
        return min(max(C, 1), T * k)
    return T * k


def _moe_local(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig):
    """The sorted path on one device.  x [T,d] → [T,d]."""
    T, d = x.shape
    E = w_gate.shape[0]
    k = cfg.top_k
    dev = x.device
    gates, ids = _route(x, router_w, k)
    flat_ids = ids.reshape(-1)                                  # [T*k]
    flat_gates = gates.reshape(-1)
    tok_of = torch.div(torch.arange(T * k, device=dev), k,
                       rounding_mode="floor")
    C = capacity(T, k, cfg.capacity_factor)
    order = torch.argsort(flat_ids, stable=True)[:C]
    sel_ids = flat_ids[order]
    sel_tok = tok_of[order]
    rows = x[sel_tok]
    gsz = (sel_ids[:, None] == torch.arange(E, device=dev)[None, :]) \
        .sum(0).to(torch.int32)
    # the cut at C drops the tail of the last groups; clamp the sizes so
    # they sum to <= C
    before = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(gsz, 0, dtype=torch.int32)[:-1]])
    gsz = torch.clamp(torch.minimum(gsz, C - before), min=0)

    cd = cfg.cdt
    act = _act(cfg.act)
    h = grouped_matmul(rows, w_gate.to(cd), gsz)
    u = grouped_matmul(rows, w_up.to(cd), gsz)
    o = grouped_matmul((act(h) * u).to(cd), w_down.to(cd), gsz)
    o = o.float() * flat_gates[order][:, None]
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    y.index_add_(0, sel_tok, o)
    return y.to(x.dtype)


def takes_sorted_path(cfg: ArchConfig) -> bool:
    """Whether :func:`moe_block` runs the sorted path (grouped products):
    more than 8 experts, the reference's rule without a mesh."""
    return cfg.n_experts > 8


def moe_block(p, cfg: ArchConfig, x):
    """[B,T,d] → [B,T,d]: the dense oracle for at most 8 experts, else the
    sorted path (:func:`takes_sorted_path`)."""
    if not takes_sorted_path(cfg):
        return moe_block_dense(p, cfg, x)
    B, T, d = x.shape
    out = _moe_local(x.reshape(B * T, d), p["router"], p["w_gate"],
                     p["w_up"], p["w_down"], cfg=cfg)
    return out.reshape(B, T, d)
