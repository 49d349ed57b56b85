"""The port's training stack (``repro_torch.training``, ``launch/train.py``)
against the JAX package's, on the same inputs and bridged weights, in fp32
on the CPU:

* losses and ``torch.autograd`` gradients against ``jax.value_and_grad``
  for every family's SMOKE config (and SDAR-8B's with remat on), with the
  masks ``jax.random`` drew for the reference passed in.  Gradients are
  held per leaf, relative to the leaf's largest value (a leaf that is
  rounding noise on both sides, a top-1 router, counts as equal): dense,
  moe, vlm and encdec at 2e-5 (loss at 1e-5); ssm and hybrid, whose
  recurrences amplify fp32 rounding, at twice the reference's own distance
  from the port's fp64 evaluation (as tests/test_torch_model.py's spread
  test measures it) plus 2e-5;
* one AdamW step (plain, factored, bfloat16 state), two steps chained, and
  ``cosine_schedule``;
* microbatched accumulation (2 against 1) on the diffusion loss, and
  against the reference's on the AR loss;
* ``SyntheticTokenStream`` batches, checkpoints (round trip, rotation, and
  the reference's checkpoints restored), ``StragglerMonitor`` and
  ``FailureInjector``;
* the trainer's restart drill, its seeded init, and ``launch.train.main``;
* ``apply`` with ``[B, 3, T]`` M-RoPE positions (vlm SMOKE).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as jtr
from repro.configs import get_smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro.models.common import ArchConfig as JaxArchConfig
from repro_torch import training as ttr
from repro_torch.configs import get_smoke_config
from repro_torch.models import ArchConfig, build_model, params_from_jax
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.train_loop import make_train_step

B, T = 2, 32
GRAD_RTOL = 2e-5
NOISE = 1e-6
LOSS_TOL = 1e-5
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8)

CASES = {
    # name: (arch, config changes, recurrent)
    "dense": ("sdar-8b", {}, False),
    "dense_remat_lengths": ("sdar-8b", {"remat": True}, False),
    "moe": ("llama4-scout-17b-a16e", {}, False),
    "vlm": ("qwen2-vl-2b", {}, False),
    "hybrid": ("jamba-1.5-large-398b", {}, True),
    "ssm": ("rwkv6-1.6b", {}, True),
    "encdec": ("seamless-m4t-large-v2", {}, False),
    "encdec_remat": ("seamless-m4t-large-v2", {"remat": True}, False),
}


def _models(arch, changes):
    jcfg = jax_smoke(arch).replace(**changes)
    tcfg = get_smoke_config(arch).replace(**changes)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _jax_masks(cfg, rng, B, T):
    """The reference objective's draws (objectives.py:25-33) for ``rng``."""
    bs = cfg.block_size
    r_key, m_key = jax.random.split(rng)
    ratios = jax.random.uniform(r_key, (B, -(-T // bs)), minval=1.0 / bs,
                                maxval=1.0)
    ratios = jnp.repeat(ratios, bs, axis=1)[:, :T]
    masked = jax.random.uniform(m_key, (B, T)) < ratios
    return {"ratios": torch.from_numpy(np.array(ratios)),
            "masked": torch.from_numpy(np.array(masked))}


def _batch(cfg, lengths=False, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.family == "encdec":
        S = 16
        return {"src_embeds": rng.normal(size=(B, S, cfg.d_model))
                .astype(np.float32),
                "src_mask": np.arange(S)[None] < np.asarray([[16], [9]]),
                "tgt_tokens": toks}
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["mm_embeds"] = rng.normal(size=(B, T, cfg.d_model)) \
            .astype(np.float32)
        batch["mm_mask"] = rng.random((B, T)) < 0.3
    if lengths:
        batch["lengths"] = np.asarray([T, 19], np.int32)
    return batch


def _port_loss(tm, leaves, batch, masks):
    fn = ttr.loss_for(tm.cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if tm.cfg.family == "encdec":
        return fn(tm, leaves, tb, masks=masks)
    extras = {k: tb[k] for k in ("mm_embeds", "mm_mask") if k in tb}
    return fn(tm, leaves, tb["tokens"], lengths=tb.get("lengths"),
              masks=masks, **extras)


def _port_value_and_grad(tm, tp, batch, masks):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    loss = _port_loss(tm, leaves, batch, masks)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {
        k: (torch.zeros_like(p) if g is None else g)
        for (k, p), g in zip(leaves.items(), grads)}


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_errors(got, want):
    """Per leaf: max |got - want| / max |want|.  A leaf whose gradient is
    rounding noise on both sides (under NOISE of the largest leaf's max:
    the router of a top-1 MoE, whose renormalised gate g/g is 1) counts
    0; noise on one side only counts 1."""
    out = {}
    floor = NOISE * max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        scale = float(np.abs(w).max())
        if scale < floor:
            out[k] = 0.0 if float(np.abs(g).max()) < floor else 1.0
        else:
            out[k] = float(np.abs(g - w).max()) / scale
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(case, monkeypatch):
    arch, changes, recurrent = CASES[case]
    jm, jp, tm, tp = _models(arch, changes)
    cfg = tm.cfg
    batch = _batch(cfg, lengths="lengths" in case)
    rng = jax.random.PRNGKey(7)
    jfn = jtr.loss_for(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if cfg.family == "encdec":
        jloss, jgrads = jax.value_and_grad(
            lambda p: jfn(jm, p, jb, rng))(jp)
    else:
        extras = {k: jb[k] for k in ("mm_embeds", "mm_mask") if k in jb}
        jloss, jgrads = jax.value_and_grad(lambda p: jfn(
            jm, p, jb["tokens"], rng, lengths=jb.get("lengths"),
            **extras))(jp)
    diffusion = jfn is not jtr.ar_loss
    masks = _jax_masks(cfg, rng, B, T) if diffusion else None
    loss, grads = _port_value_and_grad(tm, tp, batch, masks)
    jgrads = _flat(jgrads)
    assert sorted(grads) == sorted(jgrads)
    errs = _rel_errors({k: g.numpy() for k, g in grads.items()}, jgrads)
    tol = GRAD_RTOL
    if recurrent:
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "float", lambda self: self.double())
            m64 = build_model(cfg.replace(param_dtype="float64",
                                          compute_dtype="float64"))
            _, exact = _port_value_and_grad(
                m64, {k: v.double() for k, v in tp.items()}, batch,
                masks and {k: (v.double() if v.is_floating_point() else v)
                           for k, v in masks.items()})
        spread = max(_rel_errors(jgrads, {k: g.numpy()
                                          for k, g in exact.items()})
                     .values())
        tol = 2 * spread + GRAD_RTOL
        print(f"{case}: reference vs fp64 grads {spread:.3e}, tol {tol:.3e}")
    worst = max(errs, key=errs.get)
    assert errs[worst] < tol, (worst, errs[worst], tol)
    assert abs(loss - float(jloss)) < LOSS_TOL * max(1.0, abs(float(jloss)))


OPT_CASES = {
    "plain": {},
    "factored": {"factored": True},
    "bf16_state": {"state_dtype": "bfloat16"},
    "factored_bf16": {"factored": True, "state_dtype": "bfloat16"},
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_steps_match_jax(case):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **OPT_CASES[case])
    jopt, topt = jtr.AdamW(jtr.AdamWConfig(**kw)), ttr.AdamW(
        ttr.AdamWConfig(**kw))
    rng = np.random.default_rng(0)
    shapes = {"big": (256, 512), "stack": (2, 128, 160), "small": (8, 8),
              "vec": (300,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(2):
        grads = {k: (rng.normal(size=s) * (0.5 + step)).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jm = jopt.update({k: jnp.asarray(g) for k, g in
                                  grads.items()}, js, jp)
        tp2, ts2, tm = topt.update({k: torch.from_numpy(g) for k, g in
                                    grads.items()}, ts, tp)
        assert tp2 is tp and ts2 is ts                  # updated in place
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6)
            assert sorted(ts["mu"][k]) == sorted(js["mu"][k])
            for name, t in ts["mu"][k].items():
                want = np.asarray(js["mu"][k][name].astype(jnp.float32))
                assert str(t.dtype).split(".")[-1] == \
                    str(js["mu"][k][name].dtype)
                np.testing.assert_allclose(t.float().numpy(), want,
                                           rtol=1e-2 if "bf16" in case
                                           else 1e-5, atol=1e-7)


def test_cosine_schedule_matches_jax():
    for kw in (dict(), dict(warmup_steps=0, total_steps=7),
               dict(warmup_steps=5, total_steps=5, min_lr_ratio=0.0)):
        jc, tc = jtr.AdamWConfig(**kw), ttr.AdamWConfig(**kw)
        for step in (0, 1, 3, 5, 6, 50, 100, 5000, 10_000, 20_000):
            np.testing.assert_allclose(
                float(ttr.cosine_schedule(tc, step)),
                float(jtr.cosine_schedule(jc, jnp.float32(step))), rtol=1e-6)


class _GradsOut:
    """An optimizer that returns the step's gradients as its metrics."""

    def update(self, grads, state, params):
        return params, state, {"grads": grads}


def test_microbatches_equal_the_full_batch():
    """Diffusion loss, same masks: 2 microbatches against 1 (the port's
    accumulation is the full-batch loss and gradient)."""
    cfg = ArchConfig(**TINY)
    tm = build_model(cfg)
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        4, 256, (8, 32)).astype(np.int32))
    out = {}
    for mb in (1, 2):
        step = make_train_step(tm, _GradsOut(), microbatches=mb)
        _, _, out[mb] = step(tp, None, {"tokens": toks},
                             torch.Generator().manual_seed(3))
    np.testing.assert_allclose(float(out[2]["loss"]), float(out[1]["loss"]),
                               rtol=1e-6)
    errs = _rel_errors({k: g.numpy() for k, g in out[2]["grads"].items()},
                       {k: g.numpy() for k, g in out[1]["grads"].items()})
    assert max(errs.values()) < GRAD_RTOL, max(errs.items(),
                                               key=lambda kv: kv[1])


def test_microbatches_match_jax_on_the_ar_loss():
    """AR loss without lengths (every part's Σ w equal): the reference's
    mean of the parts' losses is the port's full-batch one; loss and
    gradients of 2 microbatches agree."""
    jcfg, tcfg = (JaxArchConfig(**TINY, diffusion=False),
                  ArchConfig(**TINY, diffusion=False))
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(4, 256, (8, 32)).astype(np.int32)

    class JaxGradsOut:
        def update(self, grads, state, params):
            return params, state, {"grads": grads}

    _, _, jm_out = jtr.make_train_step(jm, JaxGradsOut(), microbatches=2)(
        jp, None, {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(1))
    _, _, tm_out = make_train_step(tm, _GradsOut(), microbatches=2)(
        tp, None, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tm_out["loss"]), float(jm_out["loss"]),
                               rtol=LOSS_TOL)
    errs = _rel_errors({k: g.numpy() for k, g in tm_out["grads"].items()},
                       _flat(jm_out["grads"]))
    assert max(errs.values()) < GRAD_RTOL


def test_synthetic_stream_matches_jax():
    dc = dict(vocab_size=300, seq_len=48, global_batch=3, seed=9)
    js = jtr.SyntheticTokenStream(jtr.DataConfig(**dc))
    ts = ttr.SyntheticTokenStream(ttr.DataConfig(**dc))
    for step in (0, 1, 17):
        a, b = ts.batch(step), js.batch(step)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tree(step):
    return {"params": {"blocks/pos0/mixer/wq": torch.arange(
        12, dtype=torch.float32).reshape(3, 4) * step,
        "embed": torch.full((4, 2), float(step), dtype=torch.bfloat16)},
        "opt": {"mu": {"embed": {"m": torch.zeros(4, 2) + step}},
                "step": torch.tensor(step, dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    mgr = ttr.CheckpointManager(str(tmp_path), keep=2)
    live = _tree(1)
    for step in (10, 20, 30):
        tree = _tree(step)
        mgr.save(step, tree)
        # the save copied to the host: updating in place cannot race it
        for t in (tree["params"]["embed"], tree["opt"]["step"]):
            t.zero_()
    mgr.wait()
    assert mgr.latest_step() == 30
    restored, step = mgr.restore_latest(live)
    assert step == 30
    want = _tree(30)
    for path, t in tckpt._flatten(restored):
        w = dict(tckpt._flatten(want))[path]
        assert t.dtype == w.dtype and torch.equal(t, w), path
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_")) == \
        ["step_000000020", "step_000000030"]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's nested tree and the port's flat keys name the same
    leaves: each package restores the other's checkpoint, bf16 included."""
    jtree = {"params": {"blocks": {"pos0": {"mixer": {"wq": jnp.arange(
        12, dtype=jnp.float32).reshape(3, 4)}}},
        "embed": jnp.full((4, 2), 1.5, jnp.bfloat16)},
        "opt": {"mu": {"embed": {"m": jnp.ones((4, 2))}},
                "step": jnp.asarray(7, jnp.int32)}}
    jtr.CheckpointManager(str(tmp_path / "j"), async_save=False).save(5, jtree)
    got, step = tckpt.restore(str(tmp_path / "j"), _tree(0))
    assert step == 5
    assert torch.equal(got["params"]["blocks/pos0/mixer/wq"],
                       torch.arange(12.0).reshape(3, 4))
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["embed"].float(), torch.full((4, 2), 1.5))
    assert int(got["opt"]["step"]) == 7
    ttr.save(str(tmp_path / "t"), 3, _tree(3))
    back, step = jtr.restore(str(tmp_path / "t"), jtree)
    assert step == 3 and back["params"]["embed"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["params"]["blocks"]["pos0"]
                                             ["mixer"]["wq"]),
                                  np.arange(12).reshape(3, 4) * 3)
    assert int(back["opt"]["step"]) == 3


def test_straggler_monitor_and_injector_match_jax():
    rng = np.random.default_rng(0)
    mons = [ttr.StragglerMonitor(min_samples=4, threshold_mads=4.0),
            jtr.StragglerMonitor(min_samples=4, threshold_mads=4.0)]
    for _ in range(16):
        times = [0.1 + 0.005 * rng.random() for _ in range(8)] + \
            [0.5 + 0.01 * rng.random()]
        for mon in mons:
            for h, t in enumerate(times):
                mon.record(h, t)
    assert mons[0].stragglers() == mons[1].stragglers() == [8]
    assert mons[0].fleet_p50() == mons[1].fleet_p50()

    def fired(inj):
        out = []
        for step in range(40):
            try:
                inj.check(step)
            except Exception as e:          # SimulatedFailure of each side
                out.append((step, str(e)))
        return out

    for kw in (dict(fail_at_steps=(5, 9)), dict(fail_prob=0.2, seed=3)):
        assert fired(ttr.FailureInjector(**kw)) == \
            fired(jtr.FailureInjector(**kw))


def _trainer(tmp_path, steps, inj=None):
    dc = ttr.DataConfig(vocab_size=256, seq_len=32, global_batch=8)
    return ttr.Trainer(ArchConfig(**TINY), dc,
                       ttr.AdamWConfig(lr=1e-3, warmup_steps=3,
                                       total_steps=steps),
                       ttr.TrainerConfig(total_steps=steps, ckpt_every=6,
                                         ckpt_dir=str(tmp_path),
                                         log_every=100),
                       failure_injector=inj, device="cpu")


def test_trainer_restart_drill(tmp_path):
    """Failure at step 9, restart from the step-6 checkpoint: the resumed
    run's losses are the uninterrupted run's (same data, masks and state),
    and the loss falls."""
    clean = _trainer(tmp_path / "a", 12).run(resume=False)
    assert clean[-1] < clean[0]
    with pytest.raises(ttr.SimulatedFailure):
        _trainer(tmp_path / "b", 12, ttr.FailureInjector(
            fail_at_steps=(9,))).run(resume=False)
    resumed = _trainer(tmp_path / "b", 12).run(resume=True)
    assert len(resumed) == 6                                # steps 6..11
    np.testing.assert_allclose(resumed, clean[6:], rtol=1e-5)


def test_trainer_init_is_seeded(tmp_path):
    a = _trainer(tmp_path / "a", 1).init_state()["params"]
    b = _trainer(tmp_path / "b", 1).init_state()["params"]
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_launch_train_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    losses = train.main(["--smoke", "--torch-device", "cpu", "--steps", "3",
                         "--seq", "32", "--batch", "4", "--ckpt-dir",
                         str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
    assert tckpt.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("impl", ["train", "kernel"])
def test_apply_mrope_positions_match_jax(impl):
    """[B, 3, T] M-RoPE positions (distinct t/h/w ids) through ``apply``:
    the training route and the serving route against the reference's."""
    jm, jp, tm, tp = _models("qwen2-vl-2b", {})
    rng = np.random.default_rng(5)
    toks = rng.integers(4, tm.cfg.vocab_size, (B, T)).astype(np.int32)
    pos3 = np.stack([np.arange(T), np.arange(T) // 4, np.arange(T) % 4])
    pos3 = np.broadcast_to(pos3, (B, 3, T)).astype(np.int32)
    lens = np.asarray([T, 21], np.int32)
    want = jm.apply(jp, jnp.asarray(toks), positions=jnp.asarray(pos3),
                    mask_mode="block_causal", lengths=jnp.asarray(lens))
    got = tm.apply(tp, torch.from_numpy(toks),
                   positions=torch.from_numpy(pos3.copy()).long(),
                   mask_mode="block_causal", lengths=torch.from_numpy(lens),
                   impl=impl)
    live = np.arange(T)[None, :] < lens[:, None]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=1e-5)
