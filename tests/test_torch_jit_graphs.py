"""The JAX package's last jits in their torch form: the train step
captured as one CUDA graph (``Trainer(graphs=...)``) and the page pool's
COW copies and swap-ins replayed from the owning backend's graph cache
(``PagedKVAllocator._pool_dispatch``, kinds ``copy`` and ``swap_in``).

On the CPU the caches run with their stand-in capturer (``RerunCapturer``:
nothing captured, a replay re-runs the step or the move on the static
inputs), so everything but the CUDA graph itself is held here:

* a captured ``Trainer`` against its eager twin, bit for bit over 3
  steps (losses, params, moments): SDAR-8B SMOKE with remat, with 2
  microbatches, and the MoE and hybrid SMOKE configs; a restart drill
  whose capture follows the restore; one graph a key, a new cache a start,
  moved params or moments raising;
* the captured ``Trainer``'s losses against the reference's jitted
  ``Trainer`` on bridged weights and the reference's masks, at
  ``tests/test_torch_training.py``'s loss tolerance;
* the optimizer's device-filled bias-correction bases against the host
  tensors they replace: ``test_adamw_steps_match_jax``'s steps bit for bit;
* a captured backend committing the reference's tokens with the prefix
  cache on (COW copies) and under memory pressure with a host tier
  (swap-ins), on ``tests/test_torch_kv_parity.py``'s fixtures;
* a bf16 pool's copies and swap-ins of 1, 3, 8 and 33 pages through the
  cache against an eager twin's pool, bit for bit, within the pool churn
  bound (HLO005); a moved pool raising for each pool kind;
* a capture running with the garbage collector off.

The ``cuda`` cases hold the captured step and page moves against eager on
the card.  The JAX package is imported by the cases that use it only, so
the ``cuda`` cases run where it is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_jit_graphs.py
"""

import numpy as np
import pytest
import torch

from repro_torch import training as ttr
from repro_torch.analysis import rules
from repro_torch.configs import get_smoke_config
from repro_torch.models import ArchConfig
from repro_torch.serving.graphs import DispatchGraphs, RerunCapturer
from repro_torch.serving.kv_pool import PagedKVAllocator
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop

B, T, STEPS = 4, 32, 3
# tests/test_torch_training.py's LOSS_TOL
LOSS_TOL = 1e-5

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, block_size=8)

TRAIN_CASES = {
    # name: (arch, config changes, microbatches)
    "dense_remat": ("sdar-8b", {"remat": True}, 1),
    "dense_mb2": ("sdar-8b", {}, 2),
    "moe": ("llama4-scout-17b-a16e", {}, 1),
    "hybrid": ("jamba-1.5-large-398b", {}, 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The SMOKE models' ops are tiny, and the test workers already load
    every core: one intra-op thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(cfg, tmp_path, graphs, mb=1, device="cpu", steps=STEPS,
             ckpt_every=0, inj=None):
    return ttr.Trainer(
        cfg, ttr.DataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                            global_batch=B),
        ttr.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps),
        ttr.TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                          ckpt_dir=str(tmp_path), log_every=100,
                          microbatches=mb),
        failure_injector=inj, device=device, graphs=graphs)


def _leaves(state):
    out = dict(state["params"])
    for k, mu in state["opt"]["mu"].items():
        out.update({f"{k}@{n}": t for n, t in mu.items()})
    out["step"] = state["opt"]["step"]
    return out


def _steps(tr, n=STEPS):
    """``n`` steps of ``tr`` from a fresh state: (losses, state)."""
    state, start = tr.start(resume=False)
    losses = [float(tr.train_step(state, s)["loss"])
              for s in range(start, n)]
    return losses, state


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_captured_trainer_bit_equal_eager(case, tmp_path):
    """3 steps: the first runs eagerly and is captured, the next two
    replay; losses, params, moments and the step counter equal the eager
    twin's bit for bit, the live tensors stay in place."""
    arch, changes, mb = TRAIN_CASES[case]
    cfg = get_smoke_config(arch).replace(**changes)
    eager, e_state = _steps(_trainer(cfg, tmp_path / "e", False, mb))
    tr = _trainer(cfg, tmp_path / "c", RerunCapturer(), mb)
    state, _ = tr.start(resume=False)
    ptrs = train_loop._state_ptrs(state)
    losses = [float(tr.train_step(state, s)["loss"]) for s in range(STEPS)]
    assert losses == eager
    got, want = _leaves(state), _leaves(e_state)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
    assert train_loop._state_ptrs(state) == ptrs
    assert list(tr.graphs.entries) == [("train", B, T, mb, cfg.family)]
    assert tr.graphs.replays == STEPS - 1


def test_captured_trainer_matches_reference_trainer(tmp_path, monkeypatch):
    """The reference's jitted ``Trainer`` and the port's captured one on
    bridged weights, the port drawing the reference's masks
    (``jax.random.fold_in(PRNGKey(seed), step)`` split as its objective
    splits it): 3 losses within the loss tolerance."""
    import jax

    from repro import training as jtr
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.models import params_from_jax
    from test_torch_training import _jax_masks

    jcfg = jax_smoke("sdar-8b")
    cfg = get_smoke_config("sdar-8b")
    jt = jtr.Trainer(jcfg, jtr.DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=T, global_batch=B),
                     jtr.AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=STEPS),
                     jtr.TrainerConfig(total_steps=STEPS, ckpt_every=STEPS,
                                       ckpt_dir=str(tmp_path / "j"),
                                       log_every=100))
    jp = jt.model.init(jax.random.PRNGKey(0))
    jt.init_state = lambda: {"params": jp, "opt": jt.opt.init(jp),
                             "step": 0}
    want = jt.run(resume=False)

    tr = _trainer(cfg, tmp_path / "t", RerunCapturer())
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tr.init_state = lambda: {"params": tp, "opt": tr.opt.init(tp),
                             "step": 0}
    seed = tr.tc.seed
    monkeypatch.setattr(train_loop, "step_generator",
                        lambda s, step, device: step)
    monkeypatch.setattr(train_loop, "diffusion_masks", lambda step, b, t, bs:
                        _jax_masks(cfg, jax.random.fold_in(
                            jax.random.PRNGKey(seed), step), b, t))
    got = tr.run(resume=False)
    assert tr.graphs.replays == STEPS - 1
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


def test_moved_params_raise_one_graph_a_key(tmp_path):
    """A replay that finds a param or a moment moved raises; a key keeps
    one graph; each start makes a new cache for its state."""
    tr = _trainer(ArchConfig(**TINY), tmp_path, RerunCapturer())
    caches = []
    for moved in ("params", "opt"):
        state, _ = tr.start(resume=False)
        caches.append(tr.graphs)
        tr.train_step(state, 0)
        tr.train_step(state, 1)
        assert len(tr.graphs.entries) == 1 and tr.graphs.replays == 1
        if moved == "params":
            k = next(iter(state["params"]))
            state["params"][k] = state["params"][k].clone()
        else:
            mu = next(iter(state["opt"]["mu"].values()))
            mu["m"] = mu["m"].clone()
        with pytest.raises(RuntimeError, match="moved"):
            tr.train_step(state, 2)
    assert caches[0] is not caches[1]


def test_captured_restart_drill_resumes_bit_exact(tmp_path):
    """Failure at step 4, resume from the step-3 checkpoint: the resumed
    captured run restores, then captures, and its losses are the
    uninterrupted captured run's, bit for bit."""
    cfg = ArchConfig(**TINY)
    clean = _trainer(cfg, tmp_path / "a", RerunCapturer(), steps=6,
                     ckpt_every=3).run(resume=False)
    with pytest.raises(ttr.SimulatedFailure):
        _trainer(cfg, tmp_path / "b", RerunCapturer(), steps=6,
                 ckpt_every=3, inj=ttr.FailureInjector(
                     fail_at_steps=(4,))).run(resume=False)
    tr = _trainer(cfg, tmp_path / "b", RerunCapturer(), steps=6,
                  ckpt_every=3)
    resumed = tr.run(resume=True)
    assert resumed == clean[3:]
    assert tr.graphs.replays == 2


class _HostBases:
    """``torch`` as the optimizer saw it before the repair: ``full`` of a
    scalar is a host value copied to the device (``torch.tensor``)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def full(size, value, device=None):
        assert size == ()
        return torch.tensor(value, device=device)


@pytest.mark.parametrize("case", ["plain", "factored", "bf16_state",
                                  "factored_bf16"])
def test_adamw_device_bases_bit_identical(case, monkeypatch):
    """``test_adamw_steps_match_jax``'s two steps, with the bias
    corrections' bases filled on the device and as the host tensors they
    replace: params, moments and metrics bit-identical."""
    from test_torch_training import OPT_CASES

    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **OPT_CASES[case])
    shapes = {"big": (256, 512), "stack": (2, 128, 160), "small": (8, 8),
              "vec": (300,)}
    runs = []
    for host in (False, True):
        if host:
            monkeypatch.setattr(topt, "torch", _HostBases())
        opt = ttr.AdamW(ttr.AdamWConfig(**kw))
        rng = np.random.default_rng(0)
        tp = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()}
        ts = opt.init(tp)
        metrics = []
        for step in range(2):
            grads = {k: torch.from_numpy((rng.normal(size=s) * (0.5 + step))
                                         .astype(np.float32))
                     for k, s in shapes.items()}
            _, _, m = opt.update(grads, ts, tp)
            metrics.append((m["grad_norm"].clone(), m["lr"].clone()))
        runs.append((_leaves({"params": tp, "opt": ts}), metrics))
    (got, gm), (want, wm) = runs
    for k, t in got.items():
        assert torch.equal(t, want[k]), k
    for a, b in zip(gm, wm):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the page moves through a backend's graph cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """``tests/test_torch_kv_parity.py``'s bridged weights (diffusion on
    and off)."""
    import jax

    from repro.models import build_model as jax_build
    from repro.models.common import ArchConfig as JaxArchConfig
    from repro_torch.models import build_model, params_from_jax
    from test_torch_kv_parity import CFG

    def bridged(diffusion):
        cfg = {**CFG, "diffusion": diffusion}
        jm = jax_build(JaxArchConfig(**cfg))
        jparams = jm.init(jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
        return jm, jparams, build_model(ArchConfig(**cfg)), tparams
    return {True: bridged(True), False: bridged(False)}


@pytest.fixture(scope="module")
def kv_parity():
    import test_torch_kv_parity
    return test_torch_kv_parity


def _pool_kinds(be) -> dict:
    out = {}
    for key in be.graphs.entries:
        out[key[0]] = out.get(key[0], 0) + 1
    return out


def test_captured_prefix_cache_commits_reference_tokens(weights, kv_parity):
    """``test_prefix_cache_commits_reference_tokens``'s AR run with the
    cache on, the port's backend captured, every prompt the 32-token
    shared head (two whole pages, so each joiner re-prefills its last
    prompt token into a shared page: a COW copy): the reference's tokens
    and counters, the copies through the ``copy`` kind, the pool in
    place."""
    got = {}
    for side, extra in (("jax", {}), ("torch", {"graphs": RerunCapturer()})):
        _, serving = kv_parity.SIDES[side]
        be = kv_parity._backend(side, weights[False], n_slots=8, max_len=96,
                                decode_mode="ar", prefill_mode="chunked",
                                prefill_token_budget=16, prefix_cache=True,
                                **extra)
        if side == "torch":
            ptrs = rules.pool_ptrs(be.kv)
        reqs = kv_parity._shared_requests(serving, 5, 32, 16, 32, 2)
        got[side] = (kv_parity._drive(be, reqs, 1), be.prefix_hits,
                     be.kv.stats["cow_copies"])
    assert got["torch"] == got["jax"]
    assert got["torch"][2] > 0                  # COW copies ran
    assert _pool_kinds(be).get("copy", 0) >= 1 and be.graphs.replays > 0
    assert rules.check_pool_donation(be.kv, ptrs) == []
    assert rules.check_pool_graph_churn(be.graphs, be.kv) == []


def test_captured_swap_ins_under_pressure_commit_reference_tokens(
        weights, kv_parity):
    """``tests/test_torch_kv_parity.py``'s preemption run with a host tier
    (a tight pool of 8 pages, 64 host pages, the prefix cache on): victims
    spill and swap back through the ``swap_in`` kind, and the captured
    backend commits the reference's tokens with its preemption counts."""
    w = weights[True]
    res = {}
    for side, extra in (("jax", {}), ("torch", {"graphs": RerunCapturer()})):
        core, serving = kv_parity.SIDES[side]
        be = kv_parity._backend(side, w, max_len=64, kv_pages=8,
                                page_size=16, host_kv_pages=64, **extra)
        outs = {}
        release = be.release

        def spy(rid, be=be, outs=outs, release=release):
            outs[rid] = list(be.state(rid).output_tokens)
            release(rid)

        be.release = spy
        rep = serving.ServingEngine(be, core.FixedScheduler(8),
                                    max_batch=8).run(
            kv_parity._preemption_requests(serving))
        res[side] = (outs, rep.preemptions, be.kv.stats["swap_in_pages"])
    assert res["torch"] == res["jax"]
    assert res["torch"][2] > 0                  # swap-ins ran
    assert _pool_kinds(be).get("swap_in", 0) >= 1
    assert be.graphs.replays > 0
    assert rules.check_pool_graph_churn(be.graphs, be.kv) == []


POOL_N = (1, 3, 8, 33)


def _pools(device, capturer, P=80, host=48, dims=(2, 2, 8), seed=0):
    """A captured pool (its own graph cache, as a backend's) and an eager
    twin, bf16, filled with the same seeded pages and host pages."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for graphs in (True, False):
        kv = PagedKVAllocator(P, 16)
        kv.init_storage(*dims, dtype=torch.bfloat16, device=device)
        kv.attach_host(host)
        kv._ensure_host_storage()
        out.append(kv)
    for a, b in zip(rules.pool_tensors(out[0]) + [out[0].host.k_host,
                                                  out[0].host.v_host],
                    rules.pool_tensors(out[1]) + [out[1].host.k_host,
                                                  out[1].host.v_host]):
        x = torch.randn(a.shape, generator=g).to(torch.bfloat16)
        a.copy_(x)
        b.copy_(x)
    cap = out[0]
    cap.graphs = DispatchGraphs(device, lambda: tuple(
        t.data_ptr() for t in rules.pool_tensors(cap)), capturer=capturer)
    return out


def _moves(kv, n, rng_seed):
    rng = np.random.default_rng(rng_seed)
    pages = rng.permutation(kv.n_pages)[:2 * n].tolist()
    kv._device_copy(pages[:n], pages[n:])
    slots = rng.permutation(kv.host.n_pages)[:n].tolist()
    kv._swap_in_device(slots, pages[:n])


def _hold_pool_moves(device, capturer):
    cap, eager = _pools(device, capturer)
    ptrs = rules.pool_ptrs(cap)
    for rep in range(2):                    # capture, then replay
        for n in POOL_N:
            for kv in (cap, eager):
                _moves(kv, n, 100 * rep + n)
            for a, b in zip(rules.pool_tensors(cap),
                            rules.pool_tensors(eager)):
                assert torch.equal(a, b), (rep, n)
    buckets = {1, 4, 8, 64}
    assert sorted(cap.graphs.entries) == sorted(
        (kind, 0, n) for kind in ("copy", "swap_in") for n in buckets)
    assert cap.graphs.replays == 2 * 2 * len(POOL_N) - 2 * len(buckets)
    assert rules.check_pool_donation(cap, ptrs) == []
    assert rules.check_pool_graph_churn(cap.graphs, cap) == []
    return cap


def test_bf16_pool_moves_bit_equal_eager():
    """Copies and swap-ins of 1, 3, 8 and 33 pages into a bf16 pool
    through the cache (bf16 host pages take the torch route), twice: the
    pools bit-equal to an eager twin's after every move, one graph a kind
    and pow-2 count, the pool in place."""
    _hold_pool_moves("cpu", RerunCapturer())


@pytest.mark.parametrize("kind", ["copy", "swap_in"])
def test_moved_pool_raises_for_each_pool_kind(kind):
    cap, _ = _pools("cpu", RerunCapturer())
    move = (lambda: cap._device_copy([0, 1], [2, 3])) if kind == "copy" \
        else (lambda: cap._swap_in_device([0, 1], [2, 3]))
    move()
    move()
    cap._k_blocks[0] = cap._k_blocks[0].clone()
    with pytest.raises(RuntimeError, match="moved"):
        move()


# ---------------------------------------------------------------------------
# capture and the garbage collector
# ---------------------------------------------------------------------------

def test_capture_runs_with_the_collector_off(monkeypatch):
    """``CudaCapturer.capture`` releases the allocator's unused blocks
    first (they cannot be freed while a stream captures), then keeps the
    garbage collector off from ``capture_begin`` to ``capture_end`` (a
    graph destroyed mid-capture by the collector resets itself and
    invalidates the capture, CUDA error 901), and turns it back on after,
    also when the capture fails."""
    import contextlib
    import gc

    from repro_torch.serving import graphs

    calls = []

    class FakeGraph:
        def capture_begin(self, pool=None):
            calls.append(("begin", gc.isenabled()))

        def capture_end(self):
            calls.append(("end", gc.isenabled()))

        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append(("empty_cache",)))
    cap = object.__new__(graphs.CudaCapturer)
    cap.device, cap.stream, cap.pool = torch.device("cpu"), None, None

    def fn():
        calls.append(("fn", gc.isenabled()))
        return (torch.zeros(1),)

    assert gc.isenabled()
    cap.capture(fn, None)
    assert calls == [("empty_cache",), ("begin", False), ("fn", False),
                     ("end", False)]
    assert gc.isenabled()

    def failing():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        cap.capture(failing, None)
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# on the card: captured against eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense_remat", "dense_mb2", "moe"])
def test_captured_trainer_bit_equal_eager_on_card(cuda, case, tmp_path):
    """SMOKE in bf16 on the card (the MoE config's grouped products
    through ``torch._grouped_mm`` and its backward): 3 steps captured (a
    CUDA graph) against eager, losses and every leaf bit-equal, the live
    tensors in place, no growth of ``memory_allocated`` over a replay and
    no host sync inside one."""
    arch, changes, mb = TRAIN_CASES[case]
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16",
                                         compute_dtype="bfloat16",
                                         **changes)
    eager, e_state = _steps(_trainer(cfg, tmp_path / "e", False, mb, cuda))
    tr = _trainer(cfg, tmp_path / "c", None, mb, cuda)
    state, _ = tr.start(resume=False)
    ptrs = train_loop._state_ptrs(state)
    losses = [float(tr.train_step(state, s)["loss"]) for s in range(2)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    syncs, m = rules.count_syncs(lambda: tr.train_step(state, 2), cuda)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert syncs == 0
    losses.append(float(m["loss"]))
    assert losses == eager
    got, want = _leaves(state), _leaves(e_state)
    for k, t in got.items():
        assert torch.equal(t, want[k]), k
    assert train_loop._state_ptrs(state) == ptrs
    assert tr.graphs.replays == 2


@pytest.mark.cuda
def test_pool_moves_bit_equal_eager_on_card(cuda):
    """The page moves of ``test_bf16_pool_moves_bit_equal_eager`` as CUDA
    graphs on the card, against eager."""
    cap = _hold_pool_moves(cuda, None)
    assert cap.graphs.pool_bytes() is None or cap.graphs.pool_bytes() >= 0


@pytest.mark.cuda
def test_capture_survives_collected_graphs_on_card(cuda):
    """A graph cache left in a reference cycle (as a backend's is), then
    captures and replays while the collector would run at every
    allocation: the old graphs are collected, never during a capture."""
    import gc

    def cached():
        g = DispatchGraphs(cuda, lambda: (), capturer=None)
        g.cycle = g
        for n in (1, 2, 4):
            g.dispatch(("k", n), lambda t: (t["x"] * 2,),
                       {"x": np.arange(n, dtype=np.int64)})
        return g

    cached()                                  # garbage, 3 graphs
    keep = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = DispatchGraphs(cuda, lambda: (), capturer=None)
        for i in range(2):                    # capture, replay
            out = g.dispatch("x", lambda t: (t["x"] + 1,),
                             {"x": np.full(4, i, np.int64)})
            assert out[0].tolist() == [i + 1] * 4
    finally:
        gc.set_threshold(*keep)
