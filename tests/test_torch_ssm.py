"""The port's ``models/ssm.py`` against the JAX package's, function by
function: the same inputs, made with numpy from a seed, go through both at
SMOKE widths (RWKV6 and Jamba) and the width of
``tests/test_ssm_and_collectives.py``, with non-zero incoming states, over
sequence lengths that cover the Mamba conv state's short branch (T below
``d_conv - 1``, as AR decode runs it) and long scans.

Tolerance (fp32 on the CPU): ``rtol=0, atol=1e-5`` for every output and
state — the two frameworks sum in another order.  The split-consistency
cases hold the port to itself at the reference test's own tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import ssm as jssm
from repro.models.common import ArchConfig as JaxArchConfig
from repro.models.common import KeyGen
from repro_torch.models import ArchConfig, ssm
from repro_torch.models.bridge import params_from_jax

ATOL = 1e-5
T_CASES = [1, 2, 3, 16, 64]
# tests/test_ssm_and_collectives.py's config
SPLIT_CFG = dict(name="s", family="hybrid", d_model=32, d_state=8, d_conv=4,
                 mamba_expand=2, rwkv_head_dim=8, rwkv_lora_rank=4, d_ff=64)
CFGS = {
    "jamba_smoke": lambda: jax_smoke("jamba-1.5-large-398b"),
    "rwkv6_smoke": lambda: jax_smoke("rwkv6-1.6b"),
    "split_cfg": lambda: JaxArchConfig(**SPLIT_CFG),
}


def _cfgs(which):
    jcfg = CFGS[which]()
    return jcfg, ArchConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__})


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=ATOL)


def _params(init, jcfg, seed):
    """One layer's reference params, its zero-initialised leaves (``d_skip``,
    ``conv_b``, ``mu``, ``bonus_u``, ``ln_scale``, …) replaced by seeded
    noise so that each of them counts; numpy and torch."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v, np.float32) for k, v in
         init(KeyGen(jax.random.PRNGKey(seed)), jcfg).items()}
    p = {k: v if v.any() else 0.1 * rng.normal(size=v.shape).astype(
        np.float32) for k, v in p.items()}
    return p, params_from_jax(p, device="cpu")


def _state(tree, rng, scale=0.5):
    """Random non-zero states shaped as ``tree`` (numpy and torch)."""
    s = {k: (scale * rng.normal(size=np.shape(v))).astype(np.float32)
         for k, v in tree.items()}
    return s, {k: torch.from_numpy(v) for k, v in s.items()}


def _x(rng, B, T, d):
    x = rng.normal(size=(B, T, d)).astype(np.float32)
    return x, torch.from_numpy(x)


def test_mamba_dims_match_jax():
    for which in CFGS:
        jcfg, tcfg = _cfgs(which)
        assert ssm.mamba_dims(tcfg) == jssm.mamba_dims(jcfg)


@pytest.mark.parametrize("init", ["init_mamba", "init_rwkv_timemix",
                                  "init_rwkv_chanmix"])
@pytest.mark.parametrize("which", ["jamba_smoke", "rwkv6_smoke"])
def test_init_layout_matches_jax(which, init):
    """Names, shapes (with the leading stack axis) and dtypes of the port's
    init equal the reference's; ``a_log`` is the same deterministic table
    and the zero-initialised leaves are zero."""
    jcfg, tcfg = _cfgs(which)
    jp = getattr(jssm, init)(KeyGen(jax.random.PRNGKey(0)), jcfg)
    tp = getattr(ssm, init)(torch.Generator().manual_seed(0), tcfg, "cpu", 3)
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + tuple(v.shape), k
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
        if not np.any(np.asarray(v)):
            assert not tp[k].any(), k
    if init == "init_mamba":
        for l in range(3):
            _close(tp["a_log"][l], jp["a_log"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_states_match_jax(dtype):
    """Fresh states: shapes and dtypes (the fp32 scan states whatever the
    cache dtype), all zero."""
    jcfg, tcfg = _cfgs("jamba_smoke")
    for jfn, tfn in ((jssm.mamba_init_state, ssm.mamba_init_state),
                     (jssm.rwkv_init_state, ssm.rwkv_init_state)):
        js = jfn(jcfg, 3, getattr(jnp, dtype))
        ts = tfn(tcfg, 3, getattr(torch, dtype), device="cpu")
        assert sorted(ts) == sorted(js)
        for k, v in js.items():
            assert tuple(ts[k].shape) == tuple(v.shape)
            assert str(ts[k].dtype).split(".")[-1] == str(v.dtype), k
            assert not ts[k].any()


@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("which", ["jamba_smoke", "split_cfg"])
def test_mamba_seq_matches_jax(which, T):
    jcfg, tcfg = _cfgs(which)
    rng = np.random.default_rng(T)
    jp, tp = _params(jssm.init_mamba, jcfg, 1)
    js, ts = _state(jssm.mamba_init_state(jcfg, 2), rng)
    x, tx = _x(rng, 2, T, jcfg.d_model)
    jy, jst = jssm.mamba_seq({k: jnp.asarray(v) for k, v in jp.items()},
                             jcfg, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in js.items()})
    ty, tst = ssm.mamba_seq(tp, tcfg, tx, ts)
    _close(ty, jy)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert tst[k].dtype == torch.float32
        _close(tst[k], jst[k])


@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("which", ["rwkv6_smoke", "split_cfg"])
def test_rwkv_timemix_matches_jax(which, T):
    jcfg, tcfg = _cfgs(which)
    rng = np.random.default_rng(10 + T)
    jp, tp = _params(jssm.init_rwkv_timemix, jcfg, 2)
    st = jssm.rwkv_init_state(jcfg, 2)
    js, ts = _state({"tm_prev": st["tm_prev"], "wkv": st["wkv"]}, rng)
    x, tx = _x(rng, 2, T, jcfg.d_model)
    jy, jst = jssm.rwkv_timemix({k: jnp.asarray(v) for k, v in jp.items()},
                                jcfg, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in js.items()})
    ty, tst = ssm.rwkv_timemix(tp, tcfg, tx, ts)
    _close(ty, jy)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("T", T_CASES)
def test_rwkv_chanmix_matches_jax(T):
    jcfg, tcfg = _cfgs("rwkv6_smoke")
    rng = np.random.default_rng(20 + T)
    jp, tp = _params(jssm.init_rwkv_chanmix, jcfg, 3)
    js, ts = _state({"cm_prev": jssm.rwkv_init_state(jcfg, 2)["cm_prev"]},
                    rng)
    x, tx = _x(rng, 2, T, jcfg.d_model)
    jy, jst = jssm.rwkv_chanmix({k: jnp.asarray(v) for k, v in jp.items()},
                                jcfg, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in js.items()})
    ty, tst = ssm.rwkv_chanmix(tp, tcfg, tx, ts)
    _close(ty, jy)
    _close(tst["cm_prev"], jst["cm_prev"])


def test_token_shift_and_group_norm_match_jax():
    """``_token_shift`` exactly; ``_group_norm`` with a non-zero scale (its
    ``1 + scale``) and rows far from unit variance (population variance)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    prev = rng.normal(size=(2, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        ssm._token_shift(torch.from_numpy(x), torch.from_numpy(prev)).numpy(),
        np.asarray(jssm._token_shift(jnp.asarray(x), jnp.asarray(prev))))
    y = (3.0 * rng.normal(size=(2, 5, 4, 6)) + 1.5).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32)
    _close(ssm._group_norm(torch.from_numpy(y), torch.from_numpy(scale)),
           jssm._group_norm(jnp.asarray(y), jnp.asarray(scale)))


def test_softplus_matches_jax():
    """``softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``) on both
    sides of 20, where ``F.softplus`` switches to returning x; above 20
    the two are equal."""
    x = np.concatenate([np.linspace(-40, 40, 161),
                        [19.5, 19.99, 20.0, 20.01, 20.5, 60.0]]).astype(
                            np.float32)
    got = ssm.softplus(torch.from_numpy(x))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    _close(got, want)
    np.testing.assert_array_equal(got.numpy()[x > 20], want[x > 20])


# ---------------------------------------------------------------------------
# the port to itself: [x1 ‖ x2] == x1 then x2 (tests/test_ssm_and_collectives
# .py:32,50, at its tolerance)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 3, 8])
def test_mamba_seq_split_consistency(split):
    _, cfg = _cfgs("split_cfg")
    p = {k: v[0] for k, v in ssm.init_mamba(
        torch.Generator().manual_seed(0), cfg, "cpu", 1).items()}
    B, T = 2, 16
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(B, T, cfg.d_model)).astype(np.float32))
    st0 = ssm.mamba_init_state(cfg, B, device="cpu")
    y_full, st_full = ssm.mamba_seq(p, cfg, x, st0)
    y1, st1 = ssm.mamba_seq(p, cfg, x[:, :split], st0)
    y2, st2 = ssm.mamba_seq(p, cfg, x[:, split:], st1)
    kw = dict(rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **kw)
    torch.testing.assert_close(st2["ssm"], st_full["ssm"], **kw)
    torch.testing.assert_close(st2["conv"], st_full["conv"], **kw)


@pytest.mark.parametrize("split", [1, 5, 10])
def test_rwkv_seq_split_consistency(split):
    _, cfg = _cfgs("split_cfg")
    g = torch.Generator().manual_seed(1)
    tm = {k: v[0] for k, v in ssm.init_rwkv_timemix(g, cfg, "cpu", 1).items()}
    cm = {k: v[0] for k, v in ssm.init_rwkv_chanmix(g, cfg, "cpu", 1).items()}
    B, T = 2, 12
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, T, cfg.d_model)).astype(np.float32))
    st0 = ssm.rwkv_init_state(cfg, B, device="cpu")
    tm0 = {"tm_prev": st0["tm_prev"], "wkv": st0["wkv"]}
    y_full, stf = ssm.rwkv_timemix(tm, cfg, x, tm0)
    y1, st1 = ssm.rwkv_timemix(tm, cfg, x[:, :split], tm0)
    y2, st2 = ssm.rwkv_timemix(tm, cfg, x[:, split:], st1)
    kw = dict(rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **kw)
    torch.testing.assert_close(st2["wkv"], stf["wkv"], **kw)
    cm0 = {"cm_prev": st0["cm_prev"]}
    z_full, _ = ssm.rwkv_chanmix(cm, cfg, x, cm0)
    z1, z1s = ssm.rwkv_chanmix(cm, cfg, x[:, :split], cm0)
    z2, _ = ssm.rwkv_chanmix(cm, cfg, x[:, split:], z1s)
    torch.testing.assert_close(torch.cat([z1, z2], 1), z_full, **kw)
