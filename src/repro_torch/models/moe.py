"""Mixture-of-Experts FFN, on one device or expert-parallel over a mesh.

The counterpart of the JAX package's ``models/moe.py`` with the same
semantics, dtypes and rounding points:

* :func:`moe_block_dense` — one-hot einsum over every expert (the oracle;
  also what every config with at most 8 experts runs when no mesh is
  installed, as in the reference).
* :func:`_moe_local` — the sorted path of one shard: token-choice top-k
  routing, the (token, expert) pairs of the shard's experts (``is_local``)
  sorted by expert with a stable argsort, other shards' pairs sent past the
  cut at the capacity, one grouped product per weight
  (:func:`grouped_matmul`, the counterpart of ``lax.ragged_dot``), gates
  applied in fp32 and the pairs scatter-added back into an fp32 ``y``.  With
  one shard (the defaults) it is the whole layer.
* :func:`moe_block_sharded` — expert parallelism over the installed mesh
  (:func:`repro_torch.distributed.sharding.use_rules`): tokens split over
  the data axes, experts over the ``model`` axis; each (data, model) shard
  runs the body on its local experts, and ``y`` is summed in fp32 over the
  model axis (:func:`repro_torch.distributed.collectives.psum`).
* :func:`moe_block_2d` — the serving form: tokens replicated, experts over
  the model axis and the expert FFN dim over the data axes; each shard's
  down product is an f-partial, summed in fp32 over the data axes and the
  model axis together.

The mesh is single-controller, as the reference's ``shard_map``: a
:class:`repro_torch.launch.mesh.Mesh` names its axes, shape and devices,
:func:`repro_torch.distributed.sharding.shard_tensor` cuts each input into
its shards' pieces (on one card, views: no copy), a Python loop runs the
body once a shard, and ``psum`` reduces across the shards' outputs.
:func:`moe_block` picks among the four as the reference does
(:func:`takes_sorted_path`, ``moe_mode``).

:func:`grouped_matmul` keeps the group sizes on the device: on a CUDA
tensor it is one ``torch._grouped_mm`` call (bf16 only; anything else
raises rather than falling back, since the fallback would read the sizes
on the host), on a CPU tensor the plain loop over the groups
(:func:`grouped_matmul_loop`).

``GROUPED_CALLS`` counts grouped products that went through the CUDA
route — three a shard a MoE layer — so a run can show that its MoE layers
did.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import optrace
from repro_torch.distributed.collectives import psum
from repro_torch.distributed.sharding import (current_mesh, current_rules,
                                              shard_tensor, unshard_tensor)
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


def axes_moe(cfg: ArchConfig):
    """The logical axes of one layer's MoE weights (the reference's)."""
    return {
        "router": ("embed", None),
        "w_gate": ("experts", "embed_p", "expert_mlp_p"),
        "w_up": ("experts", "embed_p", "expert_mlp_p"),
        "w_down": ("experts", "expert_mlp_p", "embed_p"),
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


def _grouped_meta(rows, w):
    """The grouped product's shape-only route for ``meta`` rows: an empty
    ``[M, N]`` output, recorded under an op trace as one ``_grouped_mm``
    with every row counted (``2·M·K·N`` FLOPs; the group sizes are
    values a meta tensor does not have)."""
    M, K = rows.shape
    N = w.shape[-1]
    return optrace.kernel_call(
        "_grouped_mm",
        lambda: (2.0 * M * K * N, (M * K + w.numel() + M * N)
                 * rows.element_size()),
        (rows, w), lambda: rows.new_empty((M, N)))


def grouped_matmul(rows, w, group_sizes):
    """``lax.ragged_dot(rows, w, group_sizes)``.  A CUDA tensor runs one
    ``torch._grouped_mm`` with int32 end offsets computed on the device (no
    host read; bf16 only, anything else raises); a CPU tensor runs
    :func:`grouped_matmul_loop`.  Both differentiate: ``_grouped_mm``'s
    own backward gives ``dW[e] = X_eᵀ·dY_e`` and ``dX`` as the grouped
    product of ``dY`` and ``Wᵀ``."""
    global GROUPED_CALLS
    if rows.is_meta:
        return _grouped_meta(rows, w)
    if not rows.is_cuda:
        return grouped_matmul_loop(rows, w, group_sizes)
    if rows.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"grouped_matmul on CUDA takes bfloat16 (got "
                         f"{rows.dtype} rows, {w.dtype} weights)")
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    # rows past the last group are left unwritten by the library call, in
    # the output and, in its backward, in dX: mask both
    live = (torch.arange(rows.shape[0], device=rows.device) < offs[-1])[
        :, None]
    if rows.requires_grad:
        rows = torch.where(live, rows, 0)
    out = torch._grouped_mm(rows, w, offs=offs)
    GROUPED_CALLS += 1
    return torch.where(live, out, 0)


def capacity(T: int, k: int, capacity_factor: float,
             n_model: int = 1) -> int:
    """(token, expert) pairs a shard keeps: ``ceil(T·k / n_model · cf)``
    clamped to [1, T·k]; ``cf <= 0`` keeps all."""
    if capacity_factor > 0:
        C = int(np.ceil(T * k / max(n_model, 1) * capacity_factor))
        return min(max(C, 1), T * k)
    return T * k


def _moe_partial(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig,
                 n_model: int, shard: int):
    """One shard's body before its collective: x [T,d] routed over every
    expert, the pairs of the shard's ``E_loc = w_gate.shape[0]`` experts
    (ids ``[shard·E_loc, (shard+1)·E_loc)``) kept up to the capacity, and
    their gated outputs summed into an fp32 ``y`` [T,d]."""
    T, d = x.shape
    E_loc = w_gate.shape[0]
    k = cfg.top_k
    dev = x.device
    lo = shard * E_loc
    gates, ids = _route(x, router_w, k)
    flat_ids = ids.reshape(-1)                                  # [T*k]
    flat_gates = gates.reshape(-1)
    tok_of = torch.div(torch.arange(T * k, device=dev), k,
                       rounding_mode="floor")
    C = capacity(T, k, cfg.capacity_factor, n_model)
    is_local = (flat_ids >= lo) & (flat_ids < lo + E_loc)
    # other shards' pairs sort past every local one, so the cut at C keeps
    # local pairs first
    sort_key = torch.where(is_local, flat_ids, cfg.n_experts + 1)
    order = torch.argsort(sort_key, stable=True)[:C]
    sel_ids = flat_ids[order]
    sel_tok = tok_of[order]
    valid = is_local[order]
    rows = x[sel_tok] * valid[:, None].to(x.dtype)
    gsz = (sel_ids[:, None] == lo + torch.arange(E_loc, device=dev)[None, :]) \
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
    o = o.float() * (flat_gates[order] * valid)[:, None]
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    y.index_add_(0, sel_tok, o)
    return y


def _moe_local(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig,
               n_model: int = 1, shard: int = 0):
    """The sorted path of one shard, x [T,d] → [T,d] in x's dtype: with one
    shard (the defaults) the whole layer on one device."""
    return _moe_partial(x, router_w, w_gate, w_up, w_down, cfg=cfg,
                        n_model=n_model, shard=shard).to(x.dtype)


def _moe_local_2d(x, router_w, w_gate, w_up, w_down, *, cfg: ArchConfig,
                  n_model: int, shard: int):
    """The 2d body of one (data, model) shard: x [T,d] replicated, the
    weights its ``[E_loc, d, f_loc]`` / ``[E_loc, f_loc, d]`` slices, the
    capacity from ``n_model`` alone.  Returns its fp32 f-partial ``y``
    [T,d] (the down product rounded to the compute dtype over ``f_loc``),
    which :func:`moe_block_2d` sums over the data and model axes."""
    return _moe_partial(x, router_w, w_gate, w_up, w_down, cfg=cfg,
                        n_model=n_model, shard=shard)


def _shards(mesh, model_axis: str):
    """(data axes, model size, each device's model-axis index)."""
    mi = mesh.axis_names.index(model_axis)
    return (tuple(a for a in mesh.axis_names if a != model_axis),
            mesh.shape[mi],
            [mesh.coords(i)[mi] for i in range(len(mesh.devices))])


def _weights(p):
    return p["router"], p["w_gate"], p["w_up"], p["w_down"]


def moe_block_sharded(p, cfg: ArchConfig, x, *, model_axis: str = "model"):
    """Expert-parallel MoE, [B,T,d] → [B,T,d], over the installed mesh:
    the ``B·T`` tokens split contiguously over the data axes (the
    capacity from each shard's own count), the experts over
    ``model_axis``; each (data, model) shard runs :func:`_moe_partial` on
    its pieces, ``y`` is summed in fp32 over the model axis within each data
    row, cast, and put back together over the data axes.  With no mesh, or
    none with ``model_axis``, the single-shard path."""
    mesh = current_mesh()
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    if mesh is None or model_axis not in mesh.axis_names:
        return _moe_local(xf, *_weights(p), cfg=cfg).reshape(B, T, d)
    da, n_model, mi = _shards(mesh, model_axis)
    tokens = (da, None)
    xs = shard_tensor(xf, mesh, tokens)
    router = shard_tensor(p["router"], mesh, ())
    w = [shard_tensor(p[n], mesh, (model_axis,))
         for n in ("w_gate", "w_up", "w_down")]
    ys = [_moe_partial(xs[i], router[i], *(ws[i] for ws in w), cfg=cfg,
                       n_model=n_model, shard=mi[i])
          for i in range(len(mesh.devices))]
    ys = psum(ys, mesh, model_axis)
    out = unshard_tensor([y.to(x.dtype) for y in ys], mesh, tokens)
    return out.to(x.device).reshape(B, T, d)


def moe_block_2d(p, cfg: ArchConfig, x, *, model_axis: str = "model"):
    """Serving MoE with 2d-sharded expert weights, [B,T,d] → [B,T,d]: x
    replicated, the experts over ``model_axis`` and the expert FFN dim f
    over the data axes (``w_gate``/``w_up`` as ``(model, None, data)``,
    ``w_down`` as ``(model, data, None)``: strided views on one card); each
    shard's fp32 f-partial (:func:`_moe_local_2d`) is summed over the data
    axes and the model axis together, then cast.  With no mesh, or none with
    ``model_axis``, the single-shard path."""
    mesh = current_mesh()
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    if mesh is None or model_axis not in mesh.axis_names:
        return _moe_local(xf, *_weights(p), cfg=cfg).reshape(B, T, d)
    da, n_model, mi = _shards(mesh, model_axis)
    xs = shard_tensor(xf, mesh, ())
    router = shard_tensor(p["router"], mesh, ())
    wg = shard_tensor(p["w_gate"], mesh, (model_axis, None, da))
    wu = shard_tensor(p["w_up"], mesh, (model_axis, None, da))
    wd = shard_tensor(p["w_down"], mesh, (model_axis, da, None))
    ys = [_moe_local_2d(xs[i], router[i], wg[i], wu[i], wd[i], cfg=cfg,
                        n_model=n_model, shard=mi[i])
          for i in range(len(mesh.devices))]
    ys = psum(ys, mesh, da + (model_axis,))
    return ys[0].to(x.dtype).to(x.device).reshape(B, T, d)


def takes_sorted_path(cfg: ArchConfig, force_dense: bool = False) -> bool:
    """Whether :func:`moe_block` runs a sorted path (grouped products), the
    reference's rule: not ``force_dense``, and more than 8 experts or a
    mesh installed."""
    return not force_dense and (cfg.n_experts > 8
                                or current_mesh() is not None)


def moe_block(p, cfg: ArchConfig, x, *, force_dense: bool = False):
    """[B,T,d] → [B,T,d]: the dense oracle unless :func:`takes_sorted_path`;
    else :func:`moe_block_2d` when the installed rules name
    ``moe_mode = "2d"``, :func:`moe_block_sharded` otherwise."""
    if not takes_sorted_path(cfg, force_dense):
        return moe_block_dense(p, cfg, x)
    rules = current_rules()
    if rules is not None and rules.table.get("moe_mode") == "2d":
        return moe_block_2d(p, cfg, x)
    return moe_block_sharded(p, cfg, x)
