"""The port's dry run (``repro_torch.launch.specs``, ``launch.dryrun``) held
to the reference's on the CPU.

One subprocess with 8 host devices computes the reference side
(``repro.launch.specs.build_cell`` on a (data 4, model 2) mesh, no
lowering; and two 2-layer cells compiled on a 1 × 1 mesh for
``repro.analysis.hlo.analyze``).  Against it, for every cell of
``cells()``:

* every parameter, cache, optimizer-state and batch leaf has the same
  shape, dtype and partition spec in both packages (leaves named by their
  key paths joined with ``/``, the bridge's naming); the port's encdec
  cache has one leaf more, ``src_len`` (its kernel route's key counts);
* the per-device argument bytes are equal (``NamedSharding.shard_shape``
  on the reference side, the spec and the mesh shape on the port's; the
  port's extra leaf left out);
* ``model_flops`` is equal;

and on a 1 × 1 mesh the port's trace FLOPs are within 2% of the
reference's compiled-module FLOPs for ``llama3.2-1b decode_32k`` and
``smollm-135m train_4k``, each cut to 2 layers and one microbatch (the
FLOPs do not depend on the microbatch count; one keeps the trace short).
The reference's decode freezes the window into the slot cache with a
one-hot contraction, ``2·L·B·S·c·KVH·hd`` FLOPs for each of k and v,
where the port indexes (0 FLOPs); the decode comparison adds that term to
the port's count (ROADMAP queue 3 records the raw gap).  Also: each
family's ``logical_axes()`` and ``cache_logical_axes()`` against the
reference's, leaf by leaf, and the CLI's record.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ALL_ARCHS, PAPER_ARCH, cells, get_config
from repro_torch.launch.dryrun import (arg_bytes_per_device, model_flops,
                                       shard_shape, trace_step)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import build_cell

REPO = Path(__file__).resolve().parents[1]
FLOP_TOL = 0.02            # the trace's FLOPs vs the compiled module's
PORT_ONLY = {"1/src_len"}  # the encdec cache's key counts
TRACE_CELLS = [("llama3.2-1b", "decode_32k"), ("smollm-135m", "train_4k")]
CUT = {"n_layers": 2, "microbatches": 1}

_REFERENCE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
jax.devices()
import repro.launch.dryrun as dr          # after jax is up: its flag is moot
jax.config.update("jax_enable_compilation_cache", False)
from repro.analysis.hlo import analyze
from repro.configs import cells
from repro.distributed.sharding import use_rules
from repro.launch.specs import build_cell

def path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

def spec_list(spec):
    return [None if e is None else e if isinstance(e, str) else list(e)
            for e in spec]

def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

out = {"cells": {}, "flops": {}}
mesh = mesh_of((4, 2))
for arch, shape, _ in cells():
    cell = build_cell(arch, shape, mesh)
    leaves = {}
    for i, (a, sh) in enumerate(zip(cell.args, cell.in_shardings)):
        la = jax.tree_util.tree_flatten_with_path(a)[0]
        ls = jax.tree_util.tree_leaves(
            sh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        for (p, leaf), s in zip(la, ls):
            leaves[f"{i}/{path_str(p)}"] = [
                list(leaf.shape), str(leaf.dtype), spec_list(s.spec),
                int(np.prod(s.shard_shape(leaf.shape))) * leaf.dtype.itemsize]
    out["cells"][f"{arch}|{shape}"] = {
        "leaves": leaves, "model_flops": dr.model_flops(arch, shape,
                                                        cell.meta)}
mesh1 = mesh_of((1, 1))
for arch, shape in json.loads(sys.argv[2]):
    cell = build_cell(arch, shape, mesh1, cfg_overrides=json.loads(
        sys.argv[3]))
    with use_rules(cell.rules, mesh1), jax.set_mesh(mesh1):
        comp = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       donate_argnums=cell.donate_argnums).lower(
            *cell.args).compile()
    out["flops"][f"{arch}|{shape}"] = analyze(comp.as_text())["flops"]
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        json.dumps(TRACE_CELLS), json.dumps(CUT)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def _mesh(shape):
    return Mesh(("data", "model"), shape,
                (torch.device("meta"),) * math.prod(shape))


def _spec_list(s):
    return [None if e is None else e if isinstance(e, str) else list(e)
            for e in s]


def _port_leaves(cell, mesh) -> dict:
    out = {}

    def walk(t, s, pre):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], f"{pre}/{k}")
        elif isinstance(t, torch.Tensor):
            out[pre] = [list(t.shape), str(t.dtype).replace("torch.", ""),
                        _spec_list(s), math.prod(shard_shape(t.shape, s,
                                                             mesh))
                        * t.element_size()]

    for i, (a, s) in enumerate(zip(cell.args, cell.in_shardings)):
        if isinstance(a, torch.Tensor):
            out[f"{i}/"] = [list(a.shape), str(a.dtype).replace("torch.",
                                                                  ""),
                            _spec_list(s), math.prod(shard_shape(
                                a.shape, s, mesh)) * a.element_size()]
        else:
            walk(a, s, str(i))
    return out


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in cells()],
                         ids=[f"{a}-{s}" for a, s, _ in cells()])
def test_cell_leaves_bytes_and_model_flops_match_reference(ref, arch,
                                                           shape):
    mesh = _mesh((4, 2))
    cell = build_cell(arch, shape, mesh)
    want = ref["cells"][f"{arch}|{shape}"]
    mine = _port_leaves(cell, mesh)
    extra = set(mine) - set(want["leaves"])
    assert extra == (PORT_ONLY if get_config(arch).family == "encdec"
                     and cell.kind != "train" else set())
    for k, w in want["leaves"].items():
        assert mine.get(k) == w, (k, mine.get(k), w)
    assert arg_bytes_per_device(cell.args, cell.in_shardings, mesh) \
        - sum(mine[k][3] for k in extra) \
        == sum(w[3] for w in want["leaves"].values())
    assert model_flops(arch, shape, cell.meta) == want["model_flops"]


def _onehot_freeze_flops(cfg, spec_batch, seq, chunk) -> float:
    """The reference's one-hot freeze of the window into the slot cache:
    an einsum over [L, B, S, c] for k and for v."""
    S = seq + cfg.block_size
    return 2 * 2.0 * cfg.n_layers * spec_batch * S * chunk \
        * cfg.n_kv_heads * cfg.hd


@pytest.mark.parametrize("arch,shape", TRACE_CELLS,
                         ids=[f"{a}-{s}" for a, s in TRACE_CELLS])
def test_trace_flops_within_tolerance_of_compiled_module(ref, arch, shape):
    from repro_torch.configs import SHAPES
    cell = build_cell(arch, shape, _mesh((1, 1)), cfg_overrides=CUT)
    tr = trace_step(cell)
    got = tr["flops"]
    if cell.kind == "decode":
        assert tr["kernel_ops"] == {"paged_chunk_attention": 2}
        spec = SHAPES[shape]
        got += _onehot_freeze_flops(cell.model.cfg, spec.global_batch,
                                    spec.seq_len, cell.meta["chunk"])
    want = ref["flops"][f"{arch}|{shape}"]
    assert abs(got / want - 1) <= FLOP_TOL, (got, want, got / want - 1)


def _flat(tree, pre=""):
    """Key paths joined with '/' → tuple leaves (the bridge's naming)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[f"{pre}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS + [PAPER_ARCH])
def test_logical_axes_match_reference(arch):
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    model, rmodel = build_model(cfg), ref_build(ref_smoke(arch))
    assert model.logical_axes() == _flat(rmodel.logical_axes())
    if cfg.family == "encdec":
        cache = model.init_cache(2, 16, 12, device="meta")
        rcache = rmodel.init_cache(2, 16, 12, jnp.bfloat16)
    else:
        cache = model.init_cache(2, 16, device="meta")
        rcache = rmodel.init_cache(2, 16, jnp.bfloat16)
    mine = {k: v for k, v in _flat(model.cache_logical_axes(cache)).items()
            if v is not None}
    want = _flat(rmodel.cache_logical_axes(rcache))
    assert {k: v for k, v in mine.items() if k not in ("src_len",)} == want
    if cfg.family == "encdec":
        assert mine["src_len"] == ("batch",)


def test_shard_shape_is_the_pieces_shape():
    """The argument bytes come from the spec and the mesh shape alone; they
    are the bytes ``shard_tensor`` would place on each device."""
    from repro_torch.distributed.sharding import shard_tensor
    mesh = Mesh(("data", "model"), (2, 4), ("cpu",) * 8)
    x = torch.zeros(8, 12, 6)
    for spec in [(), ("data",), (None, "model"), (("data", "model"),),
                 ("model", None, "data")]:
        pieces = shard_tensor(x, mesh, spec)
        assert all(tuple(p.shape) == shard_shape(x.shape, spec, mesh)
                   for p in pieces)


def test_dryrun_cli_writes_the_record(tmp_path):
    """``python -m repro_torch.launch.dryrun`` with jax and the JAX package
    blocked: one 2-layer SDAR-8B decode cell on a (4, 2) mesh, traced on
    meta through the paged kernel's meta route."""
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['dryrun', '--arch', 'sdar-8b', '--shape', "
            "'decode_32k', '--devices', '8', '--cfg-override', "
            "'{\"n_layers\": 2}', '--force', '--out', "
            f"{str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads((tmp_path / "pod_16x16" /
                      "sdar-8b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 8
    assert rec["mesh_shape"] == {"data": 4, "model": 2}
    assert rec["trace"]["kernel_ops"] == {"paged_chunk_attention": 2}
    assert rec["meta"]["chunk"] == 8
    assert rec["flops_per_device"] * 8 == rec["trace"]["flops"]
    assert 0.9 < rec["model_over_trace_flops"] < 1.1
    assert rec["trace"]["peak_live_bytes"] > 0
    assert rec["collectives"] == {}


FAMILY_CELLS = [("llama4-scout-17b-a16e", "decode_32k", 1),
                ("kimi-k2-1t-a32b", "decode_32k", 1),
                ("qwen2-vl-2b", "prefill_32k", 1),
                ("jamba-1.5-large-398b", "decode_32k", 8),
                ("rwkv6-1.6b", "long_500k", 1),
                ("seamless-m4t-large-v2", "prefill_32k", 1)]


@pytest.mark.parametrize("arch,shape,layers", FAMILY_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in FAMILY_CELLS])
def test_every_family_traces_on_meta(arch, shape, layers):
    """One cell of each family at full width, cut in depth, traced on meta
    on a (4, 2) mesh: the MoE layers' grouped products (Scout, Kimi K2),
    the scans (Jamba, RWKV6), the encoder's admission and the wave take
    their shape-only routes; one grouped product is one op of ``2·M·K·N``
    FLOPs; the MoE bodies' analytic collective bytes."""
    from repro_torch.analysis import hlo
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.dryrun import analytic_collectives
    mesh = _mesh((4, 2))
    cell = build_cell(arch, shape, mesh, cfg_overrides={"n_layers": layers})
    with use_rules(cell.rules):
        _, tr = hlo.traced(cell.fn, *cell.args)
    cfg = cell.model.cfg
    a = hlo.analyze(tr)
    assert a["flops"] > 0 and tr.peak_bytes > 0
    grouped = [op for op in tr.ops if op.name == "_grouped_mm"]
    coll = analytic_collectives(cfg, shape, cell.meta, cell.rules, mesh)
    n_moe = sum(1 for i in range(layers) if cfg.is_moe_layer(i))
    if cfg.n_experts > 8:             # the sorted path: 3 a MoE layer
        assert len(grouped) == 3 * n_moe and a["kernels"]["_grouped_mm"]
        M, K = grouped[0].inputs[0].shape
        assert grouped[0].flops == 2.0 * M * K * grouped[0].outputs[0].shape[1]
        tokens = 128 * cell.meta["chunk"]      # decode_32k: B 128
        assert coll == {"all-reduce": n_moe * tokens * cfg.d_model * 4}
    else:
        assert not grouped
    if cfg.family == "encdec" or shape == "prefill_32k":
        assert "block_diffusion_attention" in a["kernels"]
