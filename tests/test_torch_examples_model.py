"""The example twins that run a model (``examples/serve_elastic_torch.py``,
``quickstart_torch.py``, ``train_diffusion_lm_torch.py``) against the
reference scripts beside them, in fp32 on the CPU (``--torch-device cpu``:
the kernels' plain versions):

* ``serve_elastic_torch`` on the reference run's own weights (bridged from
  the globals ``runpy.run_path`` returns) prints the reference's stdout
  exactly;
* ``quickstart_torch``: 60 training steps from the reference's initial
  weights with the reference's masks — the first 10 losses within
  ``LOSS_TOL`` (1e-5 relative) and all 60 within ``LOSS_DRIFT_TOL`` (1e-4
  relative: Adam's fp32 rounding grows over the steps) — and the decode on
  the reference's trained weights (bridged) commits the tokens of the
  reference's own library calls (``prefill``, ``chunk_forward``,
  ``freeze``, each under ``jax.jit``) with the same steps, computed tokens
  and TU, at every chunk of the script;
* ``train_diffusion_lm_torch``'s failure and restart drill: the failure at
  step ``steps // 2 + 5``, the restart from the latest checkpoint, its
  losses equal to those of an uninterrupted run resumed from the same
  checkpoint, and its printed lines the reference script's but for the
  losses, gradient norms and times (the reference seeds its weights from
  a per-process salted string hash).
* Each of the three raises without a card at its default ``cuda`` device.

The reference scripts run in this process through ``runpy.run_path``
under a patched ``sys.argv``; no reference file changes.
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chunked import ChunkedDecodeState as JaxDecodeState
from repro.core.diffusion import softmax_confidence as jax_confidence
from repro.models import ArchConfig as JaxArchConfig
from repro.models import build_model as jax_build
from repro.training import AdamW as JaxAdamW
from repro.training import AdamWConfig as JaxAdamWConfig
from repro.training import DataConfig as JaxDataConfig
from repro.training import SyntheticTokenStream as JaxStream
from repro.training import make_train_step as jax_train_step
from repro_torch.models import build_model, params_from_jax
from repro_torch.training import Trainer

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LOSS_TOL = 1e-5          # tests/test_torch_training.py's LOSS_TOL
LOSS_DRIFT_TOL = 1e-4    # all 60 quickstart steps


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """The models are tiny and the test workers load every core: two
    intra-op threads, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _twin(name):
    """The example twin ``examples/<name>_torch.py`` as a module."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *a, **kw):
    """``fn(*a, **kw)`` with its stdout captured: (result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **kw)
    return res, buf.getvalue()


def _reference(name, argv):
    """Run the reference script as ``__main__`` with ``argv``: (its
    globals, its stdout)."""
    path = str(EXAMPLES / f"{name}.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [path, *argv])
        return _run(runpy.run_path, path, run_name="__main__")


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# serve_elastic
# ---------------------------------------------------------------------------

def test_serve_elastic_prints_reference_stdout():
    """AR, fixed-8 and elastic runs, memory-elastic admission and the
    tight pool (which preempts) on the reference's weights: the same
    stdout, line for line."""
    argv = ["--requests", "4", "--out", "16", "--tight-pool"]
    g, want = _reference("serve_elastic", argv)
    twin = _twin("serve_elastic")
    res, got = _run(twin.main, [*argv, "--torch-device", "cpu"],
                    params=_bridge(g["params"]))
    assert got == want
    assert res["tight"]["completed"] == 4 and res["tight"]["drained"]
    assert res["ar"]["tokens"] == res["fixed8"]["tokens"] == 4 * 16


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def quickstart():
    """The reference quickstart's training, as the script runs it (60
    jitted steps, the rng of step i folded from ``PRNGKey(1)``): its model,
    initial and trained params, every step's loss and masks."""
    twin = _twin("quickstart")
    jcfg = JaxArchConfig(**dataclasses.asdict(twin.CFG))
    jm = jax_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    init = _bridge(params)
    data = JaxStream(JaxDataConfig(vocab_size=512, seq_len=64,
                                   global_batch=16))
    opt = JaxAdamW(JaxAdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    step = jax.jit(jax_train_step(jm, opt))
    state = opt.init(params)
    losses, masks = [], []
    for i in range(twin.STEPS):
        rng = jax.random.fold_in(jax.random.PRNGKey(1), i)
        masks.append(_jax_masks(jcfg, rng, 16, 64))
        params, state, m = step(params, state,
                                {"tokens": jnp.asarray(data.batch(i))}, rng)
        losses.append(float(m["loss"]))
    return {"twin": twin, "jm": jm, "init": init, "trained": params,
            "losses": losses, "masks": masks,
            "prompt": np.asarray(data.batch(999)[0, :16], np.int64)}


def test_quickstart_train_matches_reference(quickstart):
    q = quickstart
    twin = q["twin"]
    params = {k: v.clone() for k, v in q["init"].items()}
    model = build_model(twin.CFG)
    losses, out = _run(twin.train, model, params,
                       twin.SyntheticTokenStream(twin.DATA),
                       masks_for=lambda i: q["masks"][i])
    np.testing.assert_allclose(losses[:10], q["losses"][:10], rtol=LOSS_TOL)
    np.testing.assert_allclose(losses, q["losses"], rtol=LOSS_DRIFT_TOL)
    assert out.splitlines() == [f"train step {i}: loss {losses[i - 1]:.3f}"
                                for i in (20, 40, 60)]


def _jax_decode(jm, params, prompt, chunk):
    """The reference script's ``decode(chunk)``, its model calls jitted."""
    cfg = jm.cfg
    prefill, fwd, freeze = (jax.jit(jm.prefill), jax.jit(jm.chunk_forward),
                            jax.jit(jm.freeze))
    cache = jm.init_cache(1, 128, dtype=jnp.float32)
    _, cache = prefill(params, jnp.asarray(prompt[None], jnp.int32),
                       jnp.asarray([len(prompt)], jnp.int32), cache)
    st = JaxDecodeState(prompt_len=len(prompt), max_new_tokens=32,
                        block_size=cfg.block_size,
                        threshold=cfg.confidence_threshold,
                        mask_token=cfg.mask_token_id)
    while not st.done:
        toks, start, valid, cai = st.window(chunk)
        logits, win_kv = fwd(params, cache, jnp.asarray(toks[None], jnp.int32),
                             jnp.asarray([start], jnp.int32),
                             jnp.asarray([valid], jnp.int32))
        conf, tok = jax_confidence(np.asarray(logits[0]))
        _, n_adv = st.apply_step(conf, tok, valid, cai)
        cache = freeze(cache, win_kv, jnp.asarray([start], jnp.int32),
                       jnp.asarray([n_adv], jnp.int32))
        st.advance(n_adv)
    return st


@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_quickstart_decode_commits_reference_tokens(quickstart, chunk):
    q = quickstart
    twin = q["twin"]
    want = _jax_decode(q["jm"], q["trained"], q["prompt"], chunk)
    steps = []
    got = twin.decode(build_model(twin.CFG), _bridge(q["trained"]),
                      q["prompt"], chunk, steps=steps)
    assert got.output_tokens == want.output_tokens
    assert len(got.output_tokens) == 32
    assert (got.steps, got.computed_tokens) == (want.steps,
                                                want.computed_tokens)
    assert got.token_utilization == want.token_utilization
    assert len(steps) == got.steps
    assert sum(int(s["commit"].sum()) for s in steps) == 32


def test_quickstart_main_prints_the_scripts_lines(quickstart):
    """The whole twin from the reference's initial weights and masks: the
    reference script's lines (losses within the drift tolerance), every
    chunk's 32 tokens, and the agreements it prints."""
    q = quickstart
    twin = q["twin"]
    res, out = _run(twin.main, ["--torch-device", "cpu"], params=q["init"],
                    masks_for=lambda i: q["masks"][i])
    lines = out.splitlines()
    for k, i in enumerate((20, 40, 60)):
        assert re.fullmatch(rf"train step {i}: loss \d+\.\d{{3}}", lines[k])
        assert abs(float(lines[k].split()[-1]) - q["losses"][i - 1]) \
            <= 5e-4 + LOSS_DRIFT_TOL * q["losses"][i - 1]
    assert lines[3:5] == ["", "chunk | steps | computed | TU"]
    for line, chunk in zip(lines[5:8], twin.CHUNKS):
        d = res["decode"][chunk]
        assert line == (f"{chunk:5d} | {d['steps']:5d} | "
                        f"{d['computed_tokens']:8d} | {d['tu']:.3f}")
        assert len(res["outputs"][chunk]) == 32
    assert lines[8:10] == [f"token agreement chunk {c} vs 8: "
                           f"{res['agreement'][c]:.0%}" for c in (2, 4)]
    assert lines[10] == f"tokens: {res['outputs'][8][:16]} ..."
    assert len(lines) == 11


# ---------------------------------------------------------------------------
# train_diffusion_lm
# ---------------------------------------------------------------------------

def _structure(text):
    """Printed lines with losses, gradient norms and times blanked."""
    text = re.sub(r"loss \d+\.\d+", "loss L", text)
    text = re.sub(r"gnorm \d+\.\d+", "gnorm G", text)
    return re.sub(r"p50 step time \d+ ms", "p50 step time T ms", text)


def test_train_diffusion_lm_drill_matches_reference(tmp_path):
    """``--steps 12 --seq 32 --batch 2``: the failure at step 11, the
    restart from the checkpoint after 9 steps (``ckpt_every`` 3), the
    resumed losses bit-equal to an uninterrupted run resumed from that
    checkpoint, and the reference script's lines."""
    argv = ["--steps", "12", "--seq", "32", "--batch", "2"]
    _, want = _reference("train_diffusion_lm",
                         [*argv, "--ckpt", str(tmp_path / "jax")])
    twin = _twin("train_diffusion_lm")
    targv = [*argv, "--ckpt", str(tmp_path / "torch"), "--torch-device",
             "cpu"]
    seen = {}

    def before_restart(tr):
        # the uninterrupted run: resumed from the same checkpoint, saving
        # nothing, before the restart trains
        cfg, dc, opt, tc = twin.configs(twin.parse_args(targv))
        assert tr.tc == tc
        seen["from"] = tr.ckpt.latest_step()
        seen["losses"], _ = _run(Trainer(
            cfg, dc, opt, dataclasses.replace(tc, ckpt_every=0),
            device="cpu").run, resume=True)

    res, got = _run(twin.main, targv, before_restart=before_restart)
    assert res["failed_at"] == 11 and res["first_run_losses"] is None
    assert res["resumed_from"] == seen["from"] == 9
    assert len(res["losses"]) == 3
    assert res["losses"] == seen["losses"]
    assert res["graph_replays"] is None          # eager on the CPU
    assert _structure(got) == _structure(want)
    assert f"final loss {res['losses'][-1]:.4f}" in got


@pytest.mark.parametrize("name,argv", [
    ("serve_elastic", ["--requests", "1"]),
    ("quickstart", []),
    ("train_diffusion_lm", ["--steps", "2"]),
])
def test_model_twins_raise_without_a_card(name, argv, tmp_path):
    """At their default device, ``cuda``, the twins raise on a machine
    with no card: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    if name == "train_diffusion_lm":
        argv = [*argv, "--ckpt", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(name).main(argv)
    assert not (tmp_path / "ck").exists()
