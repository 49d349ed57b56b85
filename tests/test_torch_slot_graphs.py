"""The captured recurrent-slot dispatches (``ModelBackend`` in slot mode
through ``repro_torch.serving.graphs``).

The slot path's three dispatch kinds are the JAX package's four
recurrent-slot jits: ``slot_prefill`` (its ``_prefill``: one graph whatever
the slot or prompt length), ``window`` (``_chunk_fwd``) and ``advance``
(``_advance`` with ``_merge`` inside; one graph a distinct T, never padded).
On the CPU the cache runs with its stand-in capturer (``RerunCapturer``),
so everything but the CUDA graph itself is held here against the JAX
package: RWKV6 AR and the hybrid block-pinned, in fp32 on bridged weights,
3 requests on 2 slots.  The ``cuda`` cases capture on the card and hold
each kind bit-equal to its eager twin; the JAX package is imported by the
cases that use it only, so they run where it is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_slot_graphs.py
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.serving as tserving
from repro_torch.analysis import check, inventory
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import block_diffusion_attn as bda
from repro_torch.kernels import chunked_paged_attn as cpa
from repro_torch.models import ArchConfig, build_model, params_from_jax
from repro_torch.serving.backends import _slot_tensors
from repro_torch.serving.graphs import DispatchGraphs, RerunCapturer

# tests/test_torch_serving.py's recurrent configs (tests/test_engine.py's)
CFG_HYBRID = dict(name="h", family="hybrid", n_layers=4, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  attn_period=4, attn_offset=1, block_size=8)
CFG_RWKV = dict(name="r", family="ssm", n_layers=2, d_model=64,
                rwkv_head_dim=16, d_ff=128, vocab_size=256, diffusion=False)
# config, decode mode, fixed chunk, new tokens a request
RECURRENT = {"rwkv_ar": (CFG_RWKV, "ar", 1, 8),
             "hybrid_block_pinned": (CFG_HYBRID, "elastic", 8, 16)}


def _jax():
    """The JAX package's modules these cases compare against."""
    return {name: importlib.import_module(name) for name in (
        "jax", "repro.core", "repro.serving", "repro.models",
        "repro.models.common")}


def _bridged(cfg):
    J = _jax()
    jax = J["jax"]
    jm = J["repro.models"].build_model(
        J["repro.models.common"].ArchConfig(**cfg))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(ArchConfig(**cfg)), tparams


def _own(cfg):
    model = build_model(ArchConfig(**cfg))
    return model, model.init_params(torch.Generator().manual_seed(0),
                                    device="cpu")


def _requests(serving, cfg, n, seed):
    rng = np.random.default_rng(seed)
    reqs = list(serving.PoissonWorkload(serving.DATASETS["sharegpt"], 50.0,
                                        n, seed=seed))
    for r in reqs:
        r.prompt_len = int(rng.integers(6, 40))
        r.prompt_tokens = rng.integers(4, cfg["vocab_size"],
                                       r.prompt_len).tolist()
    return reqs


def _count_calls(be) -> dict:
    """Every slot dispatch by kind, replayed or not: the backend's
    ``_dispatch`` sees them all (a model-method hook would fire only at a
    capture).  Returns kind → the toks shapes, in call order."""
    calls = {}
    dispatch = be._dispatch

    def counted(kind, fn, **host):
        calls.setdefault(kind, []).append(host["toks"].shape)
        return dispatch(kind, fn, **host)

    be._dispatch = counted
    return calls


def _serve(side, w, which, **kw):
    cfg, mode, chunk, new = RECURRENT[which]
    jm, jparams, tm, tparams = w
    if side == "jax":
        J = _jax()
        core, serving = J["repro.core"], J["repro.serving"]
        be = serving.ModelBackend(jm, jparams, n_slots=2, max_len=64,
                                  decode_mode=mode)
    else:
        core, serving = tcore, tserving
        be = serving.ModelBackend(tm, tparams, n_slots=2, max_len=64,
                                  decode_mode=mode, device="cpu", **kw)
    calls = _count_calls(be) if side == "torch" else {}
    fetched = []
    if side == "torch":
        fetch = be._fetch

        def spy_fetch(logits):
            fetched.append(tuple(logits.shape))
            return fetch(logits)

        be._fetch = spy_fetch
    outs, release = {}, be.release

    def spy(rid):
        outs[rid] = list(be.state(rid).output_tokens)
        release(rid)

    be.release = spy
    ptrs = [t.data_ptr() for t in _slot_tensors(be.cache)] \
        if side == "torch" else None
    reqs = _requests(serving, cfg, 3, seed=5)
    for r in reqs:
        r.max_new_tokens = new
    rep = serving.ServingEngine(be, core.FixedScheduler(chunk),
                                max_batch=2).run(reqs)
    if ptrs is not None:
        assert [t.data_ptr() for t in _slot_tensors(be.cache)] == ptrs
    return {"outs": outs, "rep": rep, "be": be, "calls": calls,
            "fetched": fetched,
            "counters": (be.decode_dispatches, be.prefill_dispatches,
                         be.host_transfer_bytes)}


@pytest.fixture(scope="module", params=sorted(RECURRENT))
def served(request):
    """Each recurrent mode served by the JAX package, the eager twin
    (``graphs=False``) and the captured backend (the stand-in capturer)."""
    w = _bridged(RECURRENT[request.param][0])
    return request.param, {
        "jax": _serve("jax", w, request.param),
        "eager": _serve("torch", w, request.param, graphs=False),
        "captured": _serve("torch", w, request.param,
                           graphs=RerunCapturer())}


def test_captured_slot_backend_commits_reference_tokens(served):
    """The captured backend commits the JAX package's tokens, which equal
    the eager twin's, with the reference's chunk and batch histories and
    its (zero) dispatch and host-byte counters."""
    which, runs = served
    j, e, c = runs["jax"], runs["eager"], runs["captured"]
    new = RECURRENT[which][3]
    assert len(c["outs"]) == 3
    assert all(len(v) == new for v in c["outs"].values())
    assert c["outs"] == e["outs"] == j["outs"]
    for rep in (c["rep"], e["rep"]):
        assert rep.chunk_history == j["rep"].chunk_history
        assert rep.batch_history == j["rep"].batch_history
        assert (rep.total_tokens, rep.computed_tokens) == \
            (j["rep"].total_tokens, j["rep"].computed_tokens)
    assert c["counters"] == e["counters"] == j["counters"]
    assert c["calls"] == e["calls"]
    assert e["be"].graphs is None


def test_one_graph_a_slot_kind_and_advance_length(served):
    """Exactly one ``slot_prefill`` graph serves both slots (3 admissions);
    one ``window`` graph (the hybrid's) and one ``advance`` graph a
    distinct T; every other call a replay."""
    which, runs = served
    be, calls = runs["captured"]["be"], runs["captured"]["calls"]
    keys = list(be.graphs.entries)
    kinds = [k[0] for k in keys]
    assert len(calls["slot_prefill"]) == 3
    assert kinds.count("slot_prefill") == 1
    assert ("slot_prefill", (64,), "kernel", 1) in keys
    hybrid = which.startswith("hybrid")
    assert kinds.count("window") == int(hybrid)
    if hybrid:
        assert set(calls["window"]) == {(2, 8)}
    lengths = {shape[1] for shape in calls["advance"]}
    assert {k[1][1] for k in keys if k[0] == "advance"} == lengths
    assert kinds.count("advance") == len(lengths) > 0
    if not hybrid:
        assert lengths == {1}
    n = sum(len(v) for v in calls.values())
    assert be.graphs.replays == n - len(keys)
    assert set(kinds) <= {"slot_prefill", "window", "advance"}


@pytest.mark.parametrize("side", ["captured", "eager"])
def test_block_commits_fetch_no_logits(served, side):
    """Only logits the host samples come back (``ModelBackend._fetch``): an
    AR admission's and an AR step's (rwkv), a window's (hybrid).  A block
    commit's [n_slots, T, V] logits stay on the device, as the reference
    never fetches them."""
    which, runs = served
    calls, fetched = runs[side]["calls"], runs[side]["fetched"]
    V = RECURRENT[which][0]["vocab_size"]
    if which.startswith("hybrid"):
        assert calls["advance"]                          # block commits ran
        assert fetched == [(2, 8, V)] * len(calls["window"])
    else:
        assert sorted(fetched) == sorted([(V,)] * len(calls["slot_prefill"])
                                         + [(2, 1, V)]
                                         * len(calls["advance"]))


def _own_backend(which, **kw):
    cfg, mode = RECURRENT[which][:2]
    model, params = _own(cfg)
    return tserving.ModelBackend(model, params, n_slots=2, max_len=64,
                                 decode_mode=mode, device="cpu", **kw)


def _request(rid, prompt, seed):
    rng = np.random.default_rng(seed)
    return tserving.Request(rid=rid, arrival_time=0.0, prompt_len=prompt,
                            max_new_tokens=8,
                            prompt_tokens=rng.integers(4, 250,
                                                       prompt).tolist())


def test_moved_slot_cache_raises():
    """The slot cache's ``data_ptr``\\ s are the graph cache's pool: a
    replay that finds a slot tensor moved raises."""
    be = _own_backend("rwkv_ar", graphs=RerunCapturer())
    assert be.graphs.pool_ptrs() == tuple(t.data_ptr()
                                          for t in _slot_tensors(be.cache))
    be.admit(_request(0, 9, 0))                       # captures
    be.cache["len"] = be.cache["len"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        be.admit(_request(1, 9, 1))                   # would replay


def test_released_slot_zeros_reach_the_next_replay():
    """A released slot's zeroed ``len`` and states (written in place by
    ``_release_slot``) are what the next replays read: its row stays zero
    through an AR step of the other slot, and the next occupant's
    admission replays into it — the captured and the eager backend's
    caches equal at every step."""
    sides = [_own_backend("rwkv_ar", graphs=g)
             for g in (RerunCapturer(), False)]
    for be in sides:
        be.admit(_request(0, 12, 0))
        be.admit(_request(1, 20, 1))
        be.decode_step([0, 1], 1)                     # captures T = 1
    slot = sides[0]._slot_of[0]
    for be in sides:
        be.release(0)
        be.decode_step([1], 1)                        # replays T = 1
        assert int(be.cache["len"][slot]) == 0
        assert all(not t[:, slot].any() for st in be.cache["states"].values()
                   for t in st.values())
    for a, b in zip(*(_slot_tensors(be.cache) for be in sides)):
        assert torch.equal(a, b)
    for be in sides:
        be.admit(_request(2, 7, 2))                   # replays the prefill
        assert be._slot_of[2] == slot
        be.decode_step([1, 2], 1)
    for a, b in zip(*(_slot_tensors(be.cache) for be in sides)):
        assert torch.equal(a, b)
    assert sides[0].graphs.replays == 4
    assert [k[0] for k in sides[0].graphs.entries] == ["slot_prefill",
                                                       "advance"]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_padded_prefill_fault_through_graphs(arch):
    """tests/test_torch_serving.py::test_padded_prefill_states_match_reference
    through the graph path: a 12-token prompt admitted by a captured
    backend (the stand-in capturer) into a second slot after a first
    admission, so the one ``slot_prefill`` graph replays, still runs the
    states over the 20 pad tokens of ``max_len`` 32 — the slot's states
    equal the reference's (the dense-slot tolerance) and differ from a
    prefill of the 12 tokens alone."""
    cfg = dataclasses.asdict(get_smoke_config(arch))
    jm, jparams, tm, tparams = _bridged(cfg)
    jserving = _jax()["repro.serving"]
    first, req = _request(5, 9, 3), _request(0, 12, 0)
    be_j = jserving.ModelBackend(jm, jparams, n_slots=2, max_len=32,
                                 decode_mode="ar")
    be_t = tserving.ModelBackend(tm, tparams, n_slots=2, max_len=32,
                                 decode_mode="ar", device="cpu",
                                 graphs=RerunCapturer())
    for be in (be_j, be_t):
        for r in (first, req):
            be.admit(jserving.Request(
                rid=r.rid, arrival_time=0.0, prompt_len=r.prompt_len,
                max_new_tokens=8, prompt_tokens=r.prompt_tokens)
                if be is be_j else r)
    assert be_t.graphs.replays == 1 and len(be_t.graphs.entries) == 1
    slot = be_t._slot_of[0]
    assert be_j._slot_of[0] == slot
    alone = tm.init_cache(1, 12, dtype=torch.float32, device="cpu")
    tm.prefill(tparams, torch.as_tensor([req.prompt_tokens]),
               torch.as_tensor([12]), alone)
    moved = 0.0
    for key, st in be_t.cache["states"].items():
        for name, t in st.items():
            np.testing.assert_allclose(
                t[:, slot].numpy(),
                np.asarray(be_j.cache["states"][key][name])[:, slot],
                rtol=0, atol=2e-4)
            moved = max(moved, float((t[:, slot] - alone["states"][key][name]
                                      [:, 0]).abs().max()))
    assert moved > 1.0


def test_cpu_slot_backend_stays_eager():
    be = _own_backend("hybrid_block_pinned")
    assert be.graphs is None
    with pytest.raises(ValueError, match="CUDA device"):
        _own_backend("hybrid_block_pinned", graphs=True)


# ---------------------------------------------------------------------------
# the analyzer's rules over the slot backend
# ---------------------------------------------------------------------------

def test_slot_audit_passes_at_one_shard():
    """``audit_graphs`` at one shard also audits a slot backend on the
    hybrid audit model: no finding; one graph each of ``slot_prefill`` and
    ``window``, one ``advance`` graph a distinct length."""
    st = {}
    assert check.audit_graphs(1, "cpu", stats=st) == []
    assert st["slot"]["graphs"] == {"slot_prefill": 1, "window": 1,
                                    "advance": len(set(
                                        check.SLOT_ADVANCE_T))}
    assert set(st["slot"]["replays"]) == {"slot_prefill", "window",
                                          "advance"}


def test_hlo005_fires_on_a_planted_slot_graph(monkeypatch):
    """A slot prefill keyed by its slot (one graph a slot): HLO005 on the
    slot backend, and nothing else."""
    dispatch = DispatchGraphs.dispatch

    def keyed_by_slot(self, key, fn, host):
        if key[0] == "slot_prefill":
            key = key + (int(host["slot"][0]),)
        return dispatch(self, key, fn, host)

    monkeypatch.setattr(DispatchGraphs, "dispatch", keyed_by_slot)
    fs = check.audit_slot_graphs("cpu")
    assert [(f.rule, f.target) for f in fs] == [("HLO005", "graphs@slot")]
    assert "captured 6 graphs" in fs[0].message


@pytest.mark.parametrize("gone", [
    ("src/repro_torch/serving/backends.py", "ModelBackend._slot_prefill",
     "self.model.prefill_slot"),
    ("src/repro_torch/serving/backends.py", "ModelBackend._window",
     "self.model.chunk_forward"),
    ("src/repro_torch/serving/backends.py", "ModelBackend._advance",
     "self.model.advance_states")])
def test_hlo006_fires_on_an_unregistered_slot_site(monkeypatch, gone):
    assert gone in inventory.KNOWN_DISPATCH_SITES
    assert gone in {s[:3] for s in inventory.scan_dispatch_sites()}
    monkeypatch.setattr(inventory, "KNOWN_DISPATCH_SITES",
                        inventory.KNOWN_DISPATCH_SITES - {gone})
    fs = inventory.audit_registration()
    assert [f.rule for f in fs] == ["HLO006"]
    assert fs[0].target.startswith(gone[0]) and gone[2] in fs[0].message


# ---------------------------------------------------------------------------
# on the card: each slot kind captured against eager, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", sorted(RECURRENT))
def test_captured_slot_kinds_bit_equal_eager(cuda, which):
    """Each slot kind in bf16 through a captured backend and its eager
    twin on the same host arrays: a slot prefill into two slots (the
    second call replays), then an AR step (T 1) or a window and a block
    commit (T 3), each twice: logits bit-equal, the slot caches bit-equal
    and in place, launches a replay = the eager call's."""
    cfg = ArchConfig(**{**RECURRENT[which][0], "param_dtype": "bfloat16",
                        "compute_dtype": "bfloat16"})
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0),
                               device=cuda)
    sides = [tserving.ModelBackend(model, params, n_slots=4, max_len=64,
                                   device=cuda, cache_dtype=torch.bfloat16,
                                   graphs=g) for g in (True, False)]
    ptrs = sides[0].graphs.pool_ptrs()
    rng = np.random.default_rng(0)
    B, V, c = 4, cfg.vocab_size, cfg.block_size

    def prefill(slot, n):
        toks = np.zeros(64, np.int64)
        toks[:n] = rng.integers(4, V, n)
        return "slot_prefill", "_slot_prefill", dict(
            toks=toks, lens=np.array([n], np.int32),
            slot=np.array([slot], np.int64))

    mask = np.array([True, False, True, False])
    lens0 = np.where(mask, 1, 0).astype(np.int32)
    steps = [prefill(0, 17), prefill(2, 30)]
    if which == "rwkv_ar":
        steps += [("advance", "_advance", dict(
            toks=rng.integers(4, V, (B, 1)), lens=lens0, mask=mask))] * 2
    else:
        start = np.array([17, 0, 30, 0], np.int64)
        steps += [("window", "_window", dict(
            toks=rng.integers(4, V, (B, c)), start=start,
            valid=np.where(mask, c, 0)))] * 2
        steps += [("advance", "_advance", dict(
            toks=rng.integers(4, V, (B, 3)), lens=3 * lens0, mask=mask))] * 2
    for kind, fn, host in steps:
        n0 = cpa.LAUNCHES + bda.LAUNCHES
        got = [be._dispatch(kind, getattr(be, fn), **host)[0].cpu()
               for be in sides]
        torch.cuda.synchronize()
        assert cpa.LAUNCHES + bda.LAUNCHES - n0 == 2 * (
            model.paged_kv_dims()[0] if model.has_kv else 0)
        assert torch.equal(got[0], got[1]), kind
        assert torch.isfinite(got[0]).all()
        for a, b in zip(*(_slot_tensors(be.cache) for be in sides)):
            assert torch.equal(a, b), kind
    assert sides[0].graphs.pool_ptrs() == ptrs
    assert sides[0].graphs.replays == len(steps) - len(
        sides[0].graphs.entries)
