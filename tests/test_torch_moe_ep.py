"""The port's expert-parallel MoE (``moe_block_sharded``, ``moe_block_2d``,
``moe_block``'s dispatch), its placement over a mesh (``shard_tensor``,
``unshard_tensor``, ``psum``) and ``checkpoint.restore(shardings=)``, held to
the JAX package on the same inputs (numpy seeds, bridged weights).

The reference runs its bodies under the real ``shard_map`` on 8 forced host
devices: one subprocess (as ``tests/test_sharding_and_analysis.py`` runs
its sharded MoE) computes every mesh-side reference value — the two bodies
at (data, model) (1, 2), (2, 2), (2, 4) with capacity factors 0 and 0.5,
``jax.grad`` through the sharded body, ``moe_block`` under
``training_rules`` and ``serving_rules(moe_2d=True)``, SMOKE Scout's loss
and gradients under ``training_rules`` on (2, 4), the pieces of
``jax.device_put`` under several ``NamedSharding``s, and the checkpoint
round trip of ``tests/test_sharding_and_analysis.py:145-170`` — and writes
one ``.npz`` that the cases here read.  The port's meshes repeat the CPU
device (``Mesh(..., ("cpu",) * n)``).

Tolerances: outputs and gradients within 1e-5 of the reference's largest
value in fp32 (SMOKE Scout's gradients per leaf, a top-1 router's rounding
noise counted as equal, as in tests/test_torch_training.py); placement,
capacities and restored checkpoints exact.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.distributed.sharding import kv_shard_rules as j_kv_shard_rules
from repro.distributed.sharding import use_rules as j_use_rules
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.models.common import ArchConfig as JaxArchConfig
import repro_torch.distributed.sharding as tsh
from repro_torch import training as ttr
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.collectives import psum
from repro_torch.launch.mesh import Mesh, make_kv_mesh
from repro_torch.models import ArchConfig, build_model, moe as tmoe
from repro_torch.models import params_from_jax
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.fault_tolerance import elastic_shardings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
NOISE = 1e-6
MESHES = [(1, 2), (2, 2), (2, 4)]
CFS = [0.0, 0.5]                 # 0.5: the capacity binds, pairs drop
BODIES = {"sharded": (tmoe.moe_block_sharded, tsh.training_rules),
          "2d": (tmoe.moe_block_2d,
                 lambda: tsh.serving_rules(moe_2d=True))}
# E experts of d 32 and f 48 (f splits over 2 data shards)
CFG = dict(name="ep", family="moe", n_layers=1, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=48, moe_d_ff=48, n_experts=8, top_k=2,
           vocab_size=64, block_size=8)
TOP_K = {4: 1, 8: 2, 16: 2}      # n_experts: top_k
EXPERTS = {4: 1, 8: 2}           # the ones the reference runs on a mesh
SCOUT = "llama4-scout-17b-a16e"
SCOUT_B, SCOUT_T = 2, 32
# (name, shape, spec) of the placement cases on the (data 2, model 4) mesh
PLACE = [("rows_data", (8, 6), ("data", None)),
         ("model_data", (8, 12), ("model", "data")),
         ("both_axes_rows", (16, 3), (("data", "model"), None)),
         ("cols_model", (4, 8), (None, "model")),
         ("replicated", (5, 3), ()),
         ("experts_2d", (4, 6, 8), ("model", None, "data"))]


def _weights(E, seed=0):
    rng = np.random.default_rng(seed)
    d, f = CFG["d_model"], CFG["moe_d_ff"]
    w = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
         "w_gate": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _inputs() -> dict:
    rng = np.random.default_rng(1)
    d = CFG["d_model"]
    out = {"x": rng.normal(size=(2, 12, d)).astype(np.float32),
           "ct": rng.normal(size=(2, 12, d)).astype(np.float32),
           "scout_tokens": rng.integers(
               4, 512, (SCOUT_B, SCOUT_T)).astype(np.int32)}
    for E in TOP_K:
        out.update({f"E{E}/{k}": v for k, v in _weights(E).items()})
    for name, shape, _ in PLACE:
        out[f"place/{name}"] = np.arange(np.prod(shape), dtype=np.float32) \
            .reshape(shape)
    return out


REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import training as jtr
from repro.configs import get_smoke_config
from repro.distributed.sharding import (serving_rules, training_rules,
                                        use_rules)
from repro.models import build_model
from repro.models import moe as jmoe
from repro.models.common import ArchConfig
from repro.training import checkpoint as ck

src, dst, ckdir = sys.argv[1:4]
inp = dict(np.load(src))
CFG, EXPERTS, MESHES, CFS = {cfg}, {experts}, {meshes}, {cfs}
PLACE = {place}
out = {{}}


def mesh_of(D, M):
    devs = np.array(jax.devices()[:D * M]).reshape(D, M)
    return jax.sharding.Mesh(devs, ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


def params(E):
    return {{k: jnp.asarray(inp[f"E{{E}}/{{k}}"])
            for k in ("router", "w_gate", "w_up", "w_down")}}


x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])
bodies = {{"sharded": (jmoe.moe_block_sharded, training_rules()),
          "2d": (jmoe.moe_block_2d, serving_rules(moe_2d=True))}}
for D, M in MESHES:
    mesh = mesh_of(D, M)
    for cf in CFS:
        cfg = ArchConfig(**CFG, capacity_factor=cf)
        p = params(8)
        for name, (fn, rules) in bodies.items():
            with use_rules(rules, mesh), jax.set_mesh(mesh):
                out[f"body/{{name}}/{{D}}x{{M}}/{{cf}}"] = np.asarray(
                    jax.jit(lambda p, x: fn(p, cfg, x))(p, x))
                if name == "sharded":
                    g = jax.jit(jax.grad(lambda p, x: jnp.sum(
                        fn(p, cfg, x) * ct), argnums=(0, 1)))(p, x)
                    for k, v in {{**g[0], "x": g[1]}}.items():
                        out[f"grad/{{D}}x{{M}}/{{cf}}/{{k}}"] = np.asarray(v)

mesh = mesh_of(2, 4)
for E, k in EXPERTS.items():
    cfg = ArchConfig(**{{**CFG, "n_experts": E, "top_k": k}})
    for name, rules in (("training", training_rules()),
                        ("serving_2d", serving_rules(moe_2d=True))):
        with use_rules(rules, mesh), jax.set_mesh(mesh):
            out[f"block/{{name}}/E{{E}}"] = np.asarray(jax.jit(
                lambda p, x: jmoe.moe_block(p, cfg, x))(params(E), x))

# SMOKE Scout's loss and gradients under training_rules on (2, 4), without
# and with remat
toks = jnp.asarray(inp["scout_tokens"])
for remat in (False, True):
    model = build_model(get_smoke_config("{scout}").replace(remat=remat))
    sp = model.init(jax.random.PRNGKey(0))
    loss_fn = jtr.loss_for(model.cfg)
    with use_rules(training_rules(), mesh), jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(
            model, p, toks, jax.random.PRNGKey(7))))(sp)
    out[f"scout/{{remat}}/loss"] = np.asarray(loss)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"scout/{{remat}}/grad/" + "/".join(str(k.key) for k in path)] \
            = np.asarray(g)


def pieces(arr, mesh):
    # each device's shard, in the mesh's row-major order
    by_dev = {{s.device: np.asarray(s.data) for s in arr.addressable_shards}}
    return [by_dev[d] for d in mesh.devices.reshape(-1)]


for name, shape, spec in PLACE:
    a = jax.device_put(jnp.asarray(inp[f"place/{{name}}"]),
                       NamedSharding(mesh, P(*spec)))
    for i, s in enumerate(pieces(a, mesh)):
        out[f"place/{{name}}/{{i}}"] = s

# tests/test_sharding_and_analysis.py:145-170: saved under an 8-shard
# data mesh, restored under (2, 4) with P("model", "data")
mesh1 = jax.make_mesh((8,), ("data",),
                      axis_types=(jax.sharding.AxisType.Auto,))
tree = {{"w": jax.device_put(
    jnp.arange(64 * 32, dtype=jnp.float32).reshape(64, 32),
    NamedSharding(mesh1, P("data", None))),
    "b": jax.device_put(
        (jnp.arange(16 * 8, dtype=jnp.float32) / 7).astype(jnp.bfloat16)
        .reshape(16, 8), NamedSharding(mesh1, P("data", None)))}}
ck.save(ckdir, 7, tree)
sh = {{k: NamedSharding(mesh, P("model", "data")) for k in tree}}
restored, step = ck.restore(ckdir, tree, shardings=sh)
assert step == 7
for k, v in restored.items():
    for i, s in enumerate(pieces(v, mesh)):
        out[f"restore/{{k}}/{{i}}"] = (s.view(np.uint16)
                                      if s.dtype == jnp.bfloat16 else s)
np.savez(dst, **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's mesh-side values (one 8-device subprocess)."""
    d = tmp_path_factory.mktemp("moe_ep")
    src, dst, ckdir = d / "in.npz", d / "out.npz", d / "ck"
    np.savez(src, **_inputs())
    code = REFERENCE.format(cfg=CFG, experts=EXPERTS, meshes=MESHES,
                            cfs=CFS, place=PLACE, scout=SCOUT)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": os.path.join(REPO, "src") + ":" + REPO}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          str(src), str(dst), str(ckdir)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0 and "REFERENCE_OK" in res.stdout, \
        res.stderr[-3000:]
    return {"out": dict(np.load(dst)), "ckdir": str(ckdir)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ops are tiny and the test workers already load every core: one
    intra-op thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(D, M):
    return Mesh(("data", "model"), (D, M), ("cpu",) * (D * M))


def _cfgs(E=8, **kw):
    c = {**CFG, "n_experts": E, "top_k": TOP_K[E], **kw}
    return JaxArchConfig(**c), ArchConfig(**c)


def _params(E=8):
    w = _weights(E)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _x():
    return torch.from_numpy(_inputs()["x"])


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# the bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("body", sorted(BODIES))
def test_bodies_match_shard_map(ref, body, mesh, cf):
    """Each body on a (data, model) mesh against the reference's through
    ``shard_map``; at capacity factor 0.5 the capacity binds, so the pairs
    kept must agree (the output differs from factor 0's)."""
    fn, rules = BODIES[body]
    _, tcfg = _cfgs(capacity_factor=cf)
    _, pt = _params()
    with tsh.use_rules(rules(), _mesh(*mesh)):
        got = fn(pt, tcfg, _x())
    assert got.dtype == torch.float32
    _close(got, ref["out"][f"body/{body}/{mesh[0]}x{mesh[1]}/{cf}"])
    if cf:
        full = ref["out"][f"body/{body}/{mesh[0]}x{mesh[1]}/0.0"]
        assert float(np.abs(got.numpy() - full).max()) > 0.1


def test_capacity_matches_the_reference_formula():
    """``capacity`` against the reference's inline rule
    (``src/repro/models/moe.py:104-108``), binding and clamped cases."""
    for T in (1, 3, 12, 24, 256):
        for k in (1, 2):
            for n_model in (1, 2, 4):
                for cf in (0.0, -1.0, 0.01, 0.5, 1.25, 2.0, 100.0):
                    if cf > 0:
                        want = int(np.ceil(T * k / max(n_model, 1) * cf))
                        want = min(max(want, 1), T * k)
                    else:
                        want = T * k
                    assert tmoe.capacity(T, k, cf, n_model) == want


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_grads_match_jax_grad(ref, mesh, cf):
    """``torch.autograd`` through the sharded body against ``jax.grad``
    through ``shard_map``: the input, the experts, and the replicated
    router (its gradient summed over the shards)."""
    _, tcfg = _cfgs(capacity_factor=cf)
    _, pt = _params()
    leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
    x = _x().requires_grad_()
    with tsh.use_rules(tsh.training_rules(), _mesh(*mesh)):
        out = tmoe.moe_block_sharded(leaves, tcfg, x)
    (out * torch.from_numpy(_inputs()["ct"])).sum().backward()
    for k, v in {**leaves, "x": x}.items():
        _close(v.grad, ref["out"][f"grad/{mesh[0]}x{mesh[1]}/{cf}/{k}"])


# ---------------------------------------------------------------------------
# moe_block's dispatch
# ---------------------------------------------------------------------------

def _kv_rules():
    return tsh.kv_shard_rules(), make_kv_mesh(2, devices=["cpu"] * 2)


def _j_kv_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("kv",))


# name: (experts, port rules and mesh, the port function the block must
# equal, reference key or None to run the reference here, force_dense)
DISPATCH = {
    "no_mesh_E4": (4, None, "dense", None, False),
    "no_mesh_E16": (16, None, "sharded", None, False),
    "kv_mesh_E4": (4, _kv_rules, "sharded", None, False),
    "training_E4": (4, lambda: (tsh.training_rules(), _mesh(2, 4)),
                    "sharded", "block/training/E4", False),
    "training_E8": (8, lambda: (tsh.training_rules(), _mesh(2, 4)),
                    "sharded", "block/training/E8", False),
    "serving_2d_E4": (4, lambda: (tsh.serving_rules(moe_2d=True),
                                  _mesh(2, 4)), "2d",
                      "block/serving_2d/E4", False),
    "serving_2d_E8": (8, lambda: (tsh.serving_rules(moe_2d=True),
                                  _mesh(2, 4)), "2d",
                      "block/serving_2d/E8", False),
    "force_dense_training": (8, lambda: (tsh.training_rules(), _mesh(2, 4)),
                             "dense", None, True),
}
PATHS = {"dense": lambda p, c, x: tmoe.moe_block_dense(p, c, x),
         "sharded": tmoe.moe_block_sharded, "2d": tmoe.moe_block_2d}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_moe_block_dispatch(ref, case):
    """``moe_block`` takes the reference's path (``moe.py:255-261``): the
    dense oracle under ``force_dense`` or for at most 8 experts with no
    mesh; with a mesh installed (any mesh, a ``kv`` one too) a sorted path,
    the 2d body when the rules name ``moe_mode = "2d"``; and its output is
    the reference ``moe_block``'s."""
    E, setup, path, key, force = DISPATCH[case]
    jcfg, tcfg = _cfgs(E)
    pj, pt = _params(E)
    rules, mesh = setup() if setup else (None, None)
    with tsh.use_rules(rules, mesh):
        got = tmoe.moe_block(pt, tcfg, _x(), force_dense=force)
        assert tmoe.takes_sorted_path(tcfg, force) == (path != "dense")
        assert torch.equal(got, PATHS[path](pt, tcfg, _x()))
    if key is not None:
        want = ref["out"][key]
    else:       # no mesh, or a one-device kv mesh: no shard_map needed
        on_kv = setup is _kv_rules
        with j_use_rules(j_kv_shard_rules() if on_kv else None,
                         _j_kv_mesh() if on_kv else None):
            want = jmoe.moe_block(pj, jcfg, jnp.asarray(_x().numpy()),
                                  force_dense=force)
    _close(got, want)


# ---------------------------------------------------------------------------
# SMOKE Scout under training_rules on a (2, 4) mesh
# ---------------------------------------------------------------------------

def _rel_errors(got, want):
    """Per leaf: max |got - want| / max |want|; a leaf that is rounding
    noise on both sides (the top-1 router, whose renormalised gate is 1)
    counts 0, noise on one side only 1 (tests/test_torch_training.py)."""
    floor = NOISE * max(float(np.abs(w).max()) for w in want.values())
    out = {}
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        scale = float(np.abs(w).max())
        if scale < floor:
            out[k] = 0.0 if float(np.abs(g).max()) < floor else 1.0
        else:
            out[k] = float(np.abs(g - w).max()) / scale
    return out


@pytest.mark.parametrize("remat", [False, True])
def test_smoke_scout_loss_and_grads_under_a_mesh(ref, monkeypatch, remat):
    """SMOKE Scout (4 experts, top-1) trained under ``training_rules`` on
    a (data 2, model 4) mesh: every MoE layer takes the sharded body (one
    shard's call a (data, model) pair a layer), and the loss and every
    gradient match the reference's through ``shard_map``.  The gradient is
    taken after ``use_rules`` has exited: with remat, the recomputation
    must still run the sharded body."""
    jcfg = jax_smoke(SCOUT).replace(remat=remat)
    jm = jax_build(jcfg)
    tm = build_model(get_smoke_config(SCOUT).replace(remat=remat))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = jax.random.PRNGKey(7)
    bs = jcfg.block_size
    r_key, m_key = jax.random.split(rng)
    ratios = jax.random.uniform(r_key, (SCOUT_B, -(-SCOUT_T // bs)),
                                minval=1.0 / bs, maxval=1.0)
    ratios = jnp.repeat(ratios, bs, axis=1)[:, :SCOUT_T]
    masks = {"ratios": torch.from_numpy(np.array(ratios)),
             "masked": torch.from_numpy(np.array(
                 jax.random.uniform(m_key, (SCOUT_B, SCOUT_T)) < ratios))}
    calls = []
    body = tmoe._moe_partial
    monkeypatch.setattr(tmoe, "_moe_partial",
                        lambda *a, **k: calls.append(k["shard"]) or
                        body(*a, **k))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    toks = torch.from_numpy(_inputs()["scout_tokens"])
    with tsh.use_rules(tsh.training_rules(), _mesh(2, 4)):
        loss = ttr.loss_for(tm.cfg)(tm, leaves, toks, masks=masks)
    assert calls == [0, 1, 2, 3] * 2 * jcfg.n_layers
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    # remat recomputes each layer's forward, its MoE body on every shard
    assert calls == [0, 1, 2, 3] * 2 * jcfg.n_layers * (2 if remat else 1)
    out = ref["out"]
    want = float(out[f"scout/{remat}/loss"])
    assert abs(float(loss.detach()) - want) <= TOL * max(1.0, abs(want))
    head = f"scout/{remat}/grad/"
    jgrads = {k[len(head):]: v for k, v in out.items()
              if k.startswith(head)}
    assert sorted(jgrads) == sorted(leaves)
    errs = _rel_errors({k: (torch.zeros_like(v) if g is None else g).numpy()
                        for (k, v), g in zip(leaves.items(), grads)},
                       jgrads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < TOL, (worst, errs[worst])


# ---------------------------------------------------------------------------
# placement and the collective
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", PLACE, ids=[c[0] for c in PLACE])
def test_shard_tensor_matches_named_sharding(ref, case):
    """``shard_tensor``'s pieces, device by device, equal the shards of
    ``jax.device_put`` under the same ``NamedSharding``; on the tensor's own
    device each piece is a view; ``unshard_tensor`` puts them back."""
    name, shape, spec = case
    x = torch.from_numpy(_inputs()[f"place/{name}"])
    mesh = _mesh(2, 4)
    pieces = tsh.shard_tensor(x, mesh, spec)
    assert len(pieces) == 8
    for i, p in enumerate(pieces):
        np.testing.assert_array_equal(p.numpy(),
                                      ref["out"][f"place/{name}/{i}"])
        assert p.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
    assert torch.equal(tsh.unshard_tensor(pieces, mesh, spec), x)


@pytest.mark.parametrize("axes", ["model", ("data",), ("data", "model")])
def test_psum_over_mesh_axes(axes):
    """``psum`` sums within the groups of devices that differ only along
    ``axes``, and hands each device its group's sum."""
    mesh = _mesh(2, 4)
    xs = [torch.full((3,), float(10 ** i)) for i in range(8)]
    got = psum(xs, mesh, axes)
    names = (axes,) if isinstance(axes, str) else axes
    for i, g in enumerate(got):
        c = mesh.coords(i)
        want = sum(10.0 ** j for j in range(8) if all(
            mesh.coords(j)[k] == c[k] for k, a in enumerate(mesh.axis_names)
            if a not in names))
        assert torch.equal(g, torch.full((3,), want))


# ---------------------------------------------------------------------------
# restore(shardings=)
# ---------------------------------------------------------------------------

def _like():
    return {"w": torch.empty(64, 32), "b": torch.empty(16, 8,
                                                       dtype=torch.bfloat16)}


def test_restore_with_shardings_matches_the_reference(ref):
    """The reference's checkpoint, saved under an 8-shard ``data`` mesh,
    restored by the port under a (data 2, model 4) mesh with ``("model",
    "data")``: each piece byte-equal to the reference's shard on that
    device."""
    mesh = _mesh(2, 4)
    sh = {k: tsh.NamedSharding(mesh, ("model", "data")) for k in _like()}
    got, step = tckpt.restore(ref["ckdir"], _like(), shardings=sh)
    assert step == 7
    for k, pieces in got.items():
        assert len(pieces) == 8
        for i, p in enumerate(pieces):
            if p.dtype == torch.bfloat16:
                p = p.view(torch.int16)
            np.testing.assert_array_equal(
                p.numpy().view(ref["out"][f"restore/{k}/{i}"].dtype),
                ref["out"][f"restore/{k}/{i}"])


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_restore_roundtrip_under_another_mesh(tmp_path):
    """tests/test_sharding_and_analysis.py:145-170 in the port: a tree held
    as pieces on an 8-shard ``data`` mesh, saved whole, restored under (2,
    4) byte-exact — with ``("model", "data")`` through ``restore``, and
    with ``elastic_shardings``' specs through
    ``CheckpointManager.restore_latest``; a leaf with no sharding comes
    back whole."""
    mesh1 = Mesh(("data",), (8,), ("cpu",) * 8)
    w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    b = (torch.arange(16 * 8, dtype=torch.float32) / 7).to(
        torch.bfloat16).reshape(16, 8)
    held = {k: tsh.shard_tensor(v, mesh1, ("data", None))
            for k, v in {"w": w, "b": b}.items()}
    tree = {k: tsh.unshard_tensor(v, mesh1, ("data", None))
            for k, v in held.items()}
    assert torch.equal(tree["w"], w) and torch.equal(_bits(tree["b"]),
                                                     _bits(b))
    tree["step"] = torch.tensor(7, dtype=torch.int32)
    mgr = ttr.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, tree)
    mesh2 = _mesh(2, 4)
    rules = tsh.training_rules(data_axes=("model",), model_axis="data")
    specs = elastic_shardings({"w": ("experts", "embed_p"),
                               "b": ("experts", "embed_p")}, rules)
    assert specs == {"w": ("data", "model"), "b": ("data", "model")}
    like = {**_like(), "step": torch.tensor(0, dtype=torch.int32)}
    given = {k: ("model", "data") for k in ("w", "b")}
    runs = [(given, tckpt.restore(str(tmp_path), like, shardings={
                k: tsh.NamedSharding(mesh2, s) for k, s in given.items()})),
            (specs, mgr.restore_latest(like, shardings={
                k: tsh.NamedSharding(mesh2, s) for k, s in specs.items()}))]
    for spec, (got, step) in runs:
        assert step == 7 and torch.equal(got["step"], tree["step"])
        for k in ("w", "b"):
            want = tsh.shard_tensor(tree[k], mesh2, spec[k])
            assert len(got[k]) == 8
            for p, q in zip(got[k], want):
                assert p.dtype == q.dtype and torch.equal(_bits(p), _bits(q))
            assert torch.equal(_bits(tsh.unshard_tensor(got[k], mesh2,
                                                        spec[k])),
                               _bits(tree[k]))
