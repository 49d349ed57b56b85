"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's, on the same seeded numpy inputs and weights: the router, the
dense oracle, the sorted single-device path at a capacity factor that keeps
every pair (2.0) and one that drops (0.5), a routing where most tokens pick
one expert (the stable sort and the group-size clamp), ``moe_block``'s
branch rule, and the plain grouped product against ``lax.ragged_dot``.

Tolerances: 1e-5 absolute in float32 (the frameworks sum the products in
another order); 3e-2 relative and absolute in bfloat16
(tests/test_kernels.py).  Expert ids must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.common import ArchConfig as JaxArchConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.common import ArchConfig

# the 16-expert top-2 config of tests/test_torch_model.py (sorted path)
CFG = dict(name="moe16", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=64, moe_d_ff=48, n_experts=16, top_k=2,
           vocab_size=256, block_size=8, confidence_threshold=0.6)
TOL = {"float32": dict(rtol=0, atol=1e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _cfgs(dtype="float32", **kw):
    c = {**CFG, "param_dtype": dtype, "compute_dtype": dtype, **kw}
    return JaxArchConfig(**c), ArchConfig(**c)


def _weights(cfg, seed=0, skew=0.0):
    """One layer's MoE weights, numpy fp32.  ``skew`` adds a constant to
    expert 3's router column, so most tokens route there."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    w = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    w["router"][:, 3] += skew
    return {k: v.astype(np.float32) for k, v in w.items()}


def _both(a, dtype):
    """numpy fp32 → (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(a, np.float32)).to(
                getattr(torch, dtype)))


def _params(w, dtype):
    pj, pt = {}, {}
    for k, v in w.items():
        pj[k], pt[k] = _both(v, dtype)
    return pj, pt


def _x(shape, seed=1, shift=0.0):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) + shift


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    w = _weights(tcfg)
    xj, xt = _both(_x((40, tcfg.d_model)), dtype)
    rj, rt = _both(w["router"], dtype)
    gj, ij = jmoe._route(xj, rj, tcfg.top_k)
    gt, it = tmoe._route(xt, rt, tcfg.top_k)
    assert it.dtype == torch.int32 and gt.dtype == torch.float32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5 if dtype == "float32" else 3e-2)
    np.testing.assert_allclose(gt.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_dense_matches_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    pj, pt = _params(_weights(tcfg), dtype)
    xj, xt = _both(_x((2, 12, tcfg.d_model)), dtype)
    out = tmoe.moe_block_dense(pt, tcfg, xt)
    assert out.shape == xt.shape and out.dtype == xt.dtype
    _close(out, jmoe.moe_block_dense(pj, jcfg, xj), dtype)


# (capacity factor, router skew): keep every pair; drop half of them; most
# tokens on expert 3 and a cut through its group
LOCAL_CASES = {"cf2": (2.0, 0.0), "cf05_drop": (0.5, 0.0),
               "skewed_cf05": (0.5, 4.0), "skewed_cf2": (2.0, 4.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_moe_local_matches_jax(case, dtype):
    cf, skew = LOCAL_CASES[case]
    jcfg, tcfg = _cfgs(dtype, capacity_factor=cf)
    w = _weights(tcfg, skew=skew)
    pj, pt = _params(w, dtype)
    T = 48
    xj, xt = _both(_x((T, tcfg.d_model), shift=1.0 if skew else 0.0), dtype)
    args = ("router", "w_gate", "w_up", "w_down")
    want = jmoe._moe_local(xj, *(pj[k] for k in args), cfg=jcfg, n_model=1,
                           model_axis=None)
    got = tmoe._moe_local(xt, *(pt[k] for k in args), cfg=tcfg)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    _close(got, want, dtype)
    _, ids = tmoe._route(xt, pt["router"], tcfg.top_k)
    counts = np.bincount(ids.reshape(-1).numpy(), minlength=16)
    C = tmoe.capacity(T, tcfg.top_k, cf)
    if skew:                        # the skew does what it is for
        assert counts[3] > T // 2
    if cf < 1:                      # pairs were dropped
        assert C < T * tcfg.top_k
    else:                           # nothing dropped: the dense oracle
        dense = tmoe.moe_block_dense(pt, tcfg, xt[None])[0]
        _close(got, dense.numpy() if dtype == "float32"
               else dense.float().numpy(), dtype)


@pytest.mark.parametrize("n_experts", [8, 16])
def test_moe_block_branch_rule(n_experts):
    """At most 8 experts: the dense oracle; more: the sorted path (both
    sides' ``moe_block``, no mesh)."""
    jcfg, tcfg = _cfgs(n_experts=n_experts, top_k=2, capacity_factor=0.5)
    pj, pt = _params(_weights(tcfg), "float32")
    xj, xt = _both(_x((2, 16, tcfg.d_model)), "float32")
    got = tmoe.moe_block(pt, tcfg, xt)
    _close(got, jmoe.moe_block(pj, jcfg, xj), "float32")
    dense = tmoe.moe_block_dense(pt, tcfg, xt)
    assert tmoe.takes_sorted_path(tcfg) == (n_experts > 8)
    if n_experts <= 8:
        assert torch.equal(got, dense)
    else:       # capacity 0.5 drops pairs, so the sorted path differs
        assert not torch.allclose(got, dense, atol=1e-3)


@pytest.mark.parametrize("sizes", [[3, 0, 5, 2], [0, 0, 7, 0], [4, 4, 0, 0]])
def test_grouped_matmul_cpu_matches_ragged_dot(sizes):
    """The CPU route against ``lax.ragged_dot``: empty groups, and rows past
    the last group (sizes summing under M) come out 0."""
    rng = np.random.default_rng(3)
    M, K, N = 10, 16, 12
    rows = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(len(sizes), K, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = jax.lax.ragged_dot(jnp.asarray(rows), jnp.asarray(w),
                              jnp.asarray(gs))
    calls = tmoe.GROUPED_CALLS
    got = tmoe.grouped_matmul(torch.from_numpy(rows), torch.from_numpy(w),
                              torch.from_numpy(gs))
    assert tmoe.GROUPED_CALLS == calls        # the CPU route counts nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.all(got[int(gs.sum()):] == 0)


def test_init_moe_layout_and_scale():
    """The port's own MoE init: the reference's names and stacked shapes,
    the param dtype, and dense_init's scale (std 1/sqrt(fan_in))."""
    _, tcfg = _cfgs("bfloat16")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu", 3)
    d, f, e = tcfg.d_model, tcfg.moe_ff, tcfg.n_experts
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (3, d, e), "w_gate": (3, e, d, f), "w_up": (3, e, d, f),
        "w_down": (3, e, f, d)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    for k, fan in (("w_gate", d), ("w_down", f)):
        std = float(p[k].float().std())
        assert abs(std * np.sqrt(fan) - 1) < 0.05, (k, std)
    assert not torch.equal(p["w_gate"][0], p["w_gate"][1])
    meta = tmoe.init_moe(None, tcfg, "meta", 3)
    assert meta["w_up"].device.type == "meta"
