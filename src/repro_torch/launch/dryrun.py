"""Dry run of the production cells on the ``meta`` device, the torch form of
the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sdar-8b \\
        --shape decode_32k [--devices 256] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Per cell it writes the reference's JSON record (``status``, ``meta``,
timings, ``model_flops``) with, in place of XLA's compiled-module
analysis:

* ``arg_bytes_per_device``: each argument leaf's bytes on one device,
  exactly, from its partition spec and the mesh shape (the shard shape,
  a split dimension rounded up) — no shard is built;
* ``trace``: the step run once on ``meta`` tensors under the op trace
  (:mod:`repro_torch.analysis.optrace`) with no mesh installed, so no
  shard body runs once a device: matmul FLOPs (the hand kernels' own
  counts), bytes (Σ operand + result) and the device-memory traffic
  estimate ``hbm_bytes`` (:mod:`repro_torch.analysis.hlo`), the peak of
  live tensor bytes, ops, kernel ops;
* ``collectives``: the per-device bytes of the explicit shard bodies'
  collectives from their analytic formulas (the MoE layers' ``y``
  all-reduce; the port has no compiler inserting others);
* per-device FLOPs and bytes (the trace's, divided over the mesh) and the
  model/trace FLOP ratio.

``--devices`` gives the mesh shape for the per-device division only: no
device is created.  Nothing here imports jax.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis import hlo
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.core.latency_model import active_param_count
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch.mesh import Mesh, data_axes_of, make_production_mesh
from repro_torch.launch.specs import build_cell


def model_flops(arch: str, shape: str, meta: dict, cfg=None) -> float:
    """MODEL_FLOPS = 6·N(_active)·D for training, 2·N·D(+attn) for serving
    (``cfg``: the arch's config unless given, e.g. with overrides)."""
    cfg = cfg if cfg is not None else get_config(arch)
    spec = SHAPES[shape]
    n_active = active_param_count(cfg)
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        if cfg.family == "encdec":
            tokens = spec.global_batch * (spec.seq_len + spec.seq_len // 4)
        return 6.0 * n_active * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n_active * tokens
    # decode: one chunk step
    c = meta.get("chunk") or 1
    tokens = spec.global_batch * c
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))
    attn = 4.0 * n_attn * cfg.n_heads * cfg.hd * spec.seq_len * tokens
    return 2.0 * n_active * tokens + attn


def _leaves(tree, specs):
    """(tensor, spec) pairs of a tree of tensors and its tree of specs."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for t, s in zip(tree, specs):
            yield from _leaves(t, s)
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


def shard_shape(shape, spec, mesh: Mesh) -> tuple:
    """One device's shape of a tensor under ``spec`` on ``mesh``: each
    dimension a spec entry names divided over its axes, rounded up."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, s in zip(shape, spec):
        axes = () if s is None else (s,) if isinstance(s, str) else s
        out.append(-(-n // math.prod(mesh.size(a) for a in axes)))
    return tuple(out)


def arg_bytes_per_device(args, specs, mesh: Mesh) -> int:
    """The bytes every argument leaf puts on one device."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in _leaves(args, specs))


def analytic_collectives(cfg, shape: str, meta: dict, rules, mesh) -> dict:
    """Per-device bytes of the shard bodies' collectives in one step, by
    kind: each MoE layer's fp32 ``y`` [tokens, d] all-reduced once in the
    forward — over the model axis on each data row's ``tokens / D`` (the
    sharded body) or over every device on all the tokens (the 2d body of
    ``moe_mode = "2d"``).  No collective on a one-device group."""
    n_moe = sum(1 for i in range(cfg.n_layers)
                if cfg.n_experts and cfg.is_moe_layer(i))
    spec = SHAPES[shape]
    tokens = spec.global_batch * (meta["chunk"] or spec.seq_len)
    D = math.prod(mesh.size(a) for a in data_axes_of(mesh))
    M = mesh.size("model") if "model" in mesh.axis_names else 1
    if not n_moe or not tokens:
        return {}
    if rules.table.get("moe_mode") == "2d":
        return {"all-reduce": n_moe * tokens * cfg.d_model * 4} \
            if D * M > 1 else {}
    return {"all-reduce": n_moe * (tokens // D) * cfg.d_model * 4} \
        if M > 1 else {}


def trace_step(cell) -> dict:
    """The cell's step run once on its arguments under the op trace, with
    its rules installed and no mesh (one device's view of the whole step)."""
    with use_rules(cell.rules):
        _, tr = hlo.traced(cell.fn, *cell.args)
    a = hlo.analyze(tr)
    return {"flops": a["flops"], "bytes": a["bytes"],
            "hbm_bytes": a["hbm_bytes"],
            "peak_live_bytes": tr.peak_bytes, "ops": len(tr.ops),
            "kernel_ops": a["kernels"]}


def run_cell(arch: str, shape: str, mesh, mesh_name: str, out_dir: str,
             force: bool = False, rule_overrides=None, cfg_overrides=None,
             chunk=None, tag_suffix: str = "") -> dict:
    tag = f"{mesh_name}/{arch}__{shape}{tag_suffix}"
    path = os.path.join(out_dir, mesh_name,
                        f"{arch}__{shape}{tag_suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n_dev = len(mesh.devices)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "mesh_shape": dict(zip(mesh.axis_names, mesh.shape)),
           "devices": n_dev, "status": "error",
           "rule_overrides": rule_overrides, "cfg_overrides": cfg_overrides,
           "chunk_override": chunk}
    t0 = time.perf_counter()
    try:
        cell = build_cell(arch, shape, mesh, rule_overrides=rule_overrides,
                          cfg_overrides=cfg_overrides, chunk=chunk)
        rec["meta"] = cell.meta
        rec["arg_bytes_per_device"] = arg_bytes_per_device(
            cell.args, cell.in_shardings, mesh)
        t_build = time.perf_counter()
        rec["build_s"] = round(t_build - t0, 2)
        rec["trace"] = trace_step(cell)
        rec["trace_s"] = round(time.perf_counter() - t_build, 2)
        rec["collectives"] = analytic_collectives(
            cell.model.cfg, shape, cell.meta, cell.rules, mesh)
        rec["flops_per_device"] = rec["trace"]["flops"] / n_dev
        rec["bytes_per_device"] = rec["trace"]["bytes"] / n_dev
        rec["hbm_bytes_per_device"] = rec["trace"]["hbm_bytes"] / n_dev
        rec["model_flops"] = model_flops(arch, shape, cell.meta,
                                         cfg=cell.model.cfg)
        rec["model_over_trace_flops"] = rec["model_flops"] / max(
            rec["trace"]["flops"], 1.0)
        rec["status"] = "ok"
        print(f"[{tag}] OK build={rec['build_s']}s trace={rec['trace_s']}s "
              f"args/dev={rec['arg_bytes_per_device'] / 2**30:.2f}GiB "
              f"peak live={rec['trace']['peak_live_bytes'] / 2**30:.2f}GiB")
        print(f"[{tag}] trace: flops={rec['trace']['flops']:.3e} "
              f"bytes={rec['trace']['bytes']:.3e} "
              f"model/trace_flops={rec['model_over_trace_flops']:.3f} "
              f"collectives/dev={rec['collectives']}")
    except Exception as e:                                     # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{tag}] FAIL: {rec['error']}")
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def meshes_for(n_dev: int, multi_pod: bool, both: bool) -> list:
    """(name, mesh) pairs as the reference builds them: the production
    mesh when ``n_dev`` covers it, else its reduced test topology; every
    device ``meta``."""
    out = []
    for mp in ([False, True] if both else [multi_pod]):
        want = 512 if mp else 256
        if n_dev >= want:
            mesh = make_production_mesh(multi_pod=mp,
                                        devices=["meta"] * want)
        elif n_dev < 2:
            mesh = Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
        elif mp:
            mesh = Mesh(("pod", "data", "model"), (2, n_dev // 4, 2),
                        (torch.device("meta"),) * (n_dev // 4 * 4))
        else:
            mesh = Mesh(("data", "model"), (n_dev // 2, 2),
                        (torch.device("meta"),) * (n_dev // 2 * 2))
        out.append(("multipod_2x16x16" if mp else "pod_16x16", mesh))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run on the meta device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--devices", type=int, default=512,
                    help="the mesh's device count (shape only)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--rules-override", default=None,
                    help='JSON, e.g. {"heads": null, "batch": ["data","model"]}')
    ap.add_argument("--cfg-override", default=None,
                    help='JSON ArchConfig field overrides (perf sweeps)')
    ap.add_argument("--chunk", type=int, default=None,
                    help="decode chunk size override")
    ap.add_argument("--tag", default="", help="suffix for output filename")
    args = ap.parse_args(argv)
    rule_overrides = json.loads(args.rules_override) \
        if args.rules_override else None
    cfg_overrides = json.loads(args.cfg_override) if args.cfg_override \
        else None

    if args.all:
        todo = [(a, s) for a, s, _ in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    meshes = meshes_for(args.devices, args.multi_pod, args.both_meshes)
    failures = 0
    for mesh_name, mesh in meshes:
        for arch, shape in todo:
            rec = run_cell(arch, shape, mesh, mesh_name, args.out,
                           force=args.force, rule_overrides=rule_overrides,
                           cfg_overrides=cfg_overrides, chunk=args.chunk,
                           tag_suffix=args.tag)
            failures += rec["status"] != "ok"
    print(f"dry-run complete: {len(todo) * len(meshes) - failures} ok, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
