"""Logical-axis sharding rules.

Models name the axes of parameters and activations with *logical* names
("batch", "embed", "heads", ...).  A :class:`Rules` object maps logical
names to physical mesh axes.  The launcher installs rules for its mesh;
with no rules installed every lookup gives the empty spec.  This mirrors
the t5x/MaxText logical-axis-rules design of the JAX package.

A spec is a plain tuple with one entry a dimension: a mesh-axis name, a
tuple of names, or ``None`` (the counterpart of ``PartitionSpec``); a
:class:`NamedSharding` is a mesh and a spec.  The port places tensors
itself: :func:`shard_tensor` cuts a tensor into the pieces of a (mesh,
spec), one a device of the mesh, and :func:`unshard_tensor` puts pieces
back together.  The expert-parallel MoE bodies
(:mod:`repro_torch.models.moe`) and ``checkpoint.restore(shardings=)``
place through them; the sharded page pool
(:meth:`repro_torch.serving.kv_pool.PagedKVAllocator.init_storage`) puts
its blocks on the devices of its ``KVShardSpec``.  So :func:`shard`, the
JAX package's sharding hint on activations, is the identity: there is no
compiler for a hint to reach, and the models do not call it.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import Mapping

# Logical axis vocabulary used across the model zoo.
#   batch      : global batch dimension (tokens dim 0)
#   seq        : sequence dimension
#   embed      : d_model activations dim
#   heads      : query heads
#   kv_heads   : key/value heads
#   head_dim   : per-head feature dim
#   mlp        : FFN hidden dim
#   vocab      : vocabulary dim
#   experts    : MoE expert dim
#   expert_mlp : per-expert FFN hidden dim
#   kv_seq     : cached KV sequence dim (decode); seq-sharded for split-KV
#   kv_pages   : paged KV pool page dim (serving); sharded for split-KV
#                paged decode (see kv_shard_rules)
#   state      : SSM state dim
#   layers     : stacked-layer dim (never sharded)
# Param-only FSDP aliases (weights can shard differently from activations):
#   embed_p / mlp_p / vocab_p / heads_p / expert_mlp_p


@dataclass(frozen=True)
class Rules:
    """Mapping from logical axis names to mesh axes (or None)."""

    table: Mapping[str, object] = field(default_factory=dict)

    def spec(self, *logical: str | None) -> tuple:
        """Translate logical names into a spec tuple.

        A mesh axis may appear at most once in a spec; on conflict the first
        occurrence wins and later dims fall back to None.
        """
        used: set[str] = set()
        out = []
        for name in logical:
            axis = self.table.get(name) if name is not None else None
            if axis is None:
                out.append(None)
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                out.append(None)
                continue
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        return tuple(out)

    def with_overrides(self, **kv) -> "Rules":
        table = dict(self.table)
        table.update(kv)
        return replace(self, table=table)


# ---------------------------------------------------------------------------
# Rule presets
# ---------------------------------------------------------------------------

def training_rules(data_axes=("data",), model_axis="model",
                   fsdp: bool = True) -> Rules:
    """Default production training rules: DP over ``data_axes``, TP over
    ``model_axis``, FSDP weight sharding over the data axes."""
    da = tuple(data_axes)
    da_key = da if len(da) > 1 else da[0]
    table = {
        "batch": da_key,
        "seq": None,
        "embed": None,
        "heads": model_axis,
        "kv_heads": None,
        "head_dim": None,
        "mlp": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "expert_mlp": da_key if fsdp else None,
        "kv_seq": None,
        "kv_pages": None,
        "state": None,
        "layers": None,
        # FSDP param axes: shard big weight matrices along their non-TP dim.
        "embed_p": da_key if fsdp else None,
        "mlp_p": model_axis,
        "vocab_p": model_axis,
        "heads_p": model_axis,
        "expert_mlp_p": da_key if fsdp else None,
    }
    return Rules(table)


def serving_rules(data_axes=("data",), model_axis="model",
                  seq_shard_kv: bool = True, moe_2d: bool = False) -> Rules:
    """Serving rules: batch over data, TP over model, decode KV cache
    sequence-sharded over the model axis (split-KV attention).

    Expert weights are 2D-sharded (experts × model, expert-FFN dim × data);
    ``moe_2d=True`` names the f-partial MoE for decode (``moe_mode``).
    """
    da = tuple(data_axes)
    da_key = da if len(da) > 1 else da[0]
    table = {
        "batch": da_key,
        "seq": None,
        "embed": None,
        "heads": model_axis,
        "kv_heads": None,
        "head_dim": None,
        "mlp": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "expert_mlp": None,
        "kv_seq": model_axis if seq_shard_kv else None,
        "kv_pages": None,
        "state": None,
        "layers": None,
        "embed_p": None,
        "mlp_p": model_axis,
        "vocab_p": model_axis,
        "heads_p": model_axis,
        "expert_mlp_p": da_key,
        "moe_mode": "2d" if moe_2d else "gather",
    }
    return Rules(table)


def long_context_rules(data_axes=("data",), model_axis="model") -> Rules:
    """long_500k rules: batch=1 ⇒ shard the KV/state sequence over *data*
    (sequence parallelism) and keep TP over model."""
    return serving_rules(data_axes, model_axis, moe_2d=True).with_overrides(
        batch=None, kv_seq="data", seq="data",
    )


def kv_shard_rules(kv_axis: str = "kv", data_axes=("data",),
                   model_axis: str = "model") -> Rules:
    """Sharded-page-pool serving rules: the paged KV pool's *page* dim is
    sharded over ``kv_axis`` (split-KV paged decode — each shard owns a
    block of physical pages and attends only over them), and the dense
    decode cache's ``kv_seq`` moves onto the same axis.
    The JAX package lays its pool out with ``rules.spec("layers",
    "kv_pages", None, "kv_heads", "head_dim")``; the port's pool takes the
    devices of its ``KVShardSpec`` (axis ``kv_axis``) instead.
    """
    return serving_rules(data_axes, model_axis).with_overrides(
        kv_pages=kv_axis, kv_seq=kv_axis)


# ---------------------------------------------------------------------------
# Context management
# ---------------------------------------------------------------------------

class _State(threading.local):
    def __init__(self):
        self.rules: Rules | None = None
        self.mesh = None


_state = _State()


@contextlib.contextmanager
def use_rules(rules: Rules | None, mesh=None):
    prev = (_state.rules, _state.mesh)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def current_rules() -> Rules | None:
    return _state.rules


def current_mesh():
    return _state.mesh


def logical_spec(*logical: str | None) -> tuple:
    rules = current_rules()
    if rules is None:
        return ()
    return rules.spec(*logical)


def shard(x, *logical: str | None):
    """The identity (see the module docstring)."""
    return x


def _map_specs(fn, tree):
    """Map ``fn`` over the tuples of a tree of dicts and lists (tuples are
    leaves, ``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def param_specs(logical_tree):
    """Map a tree of logical-axis tuples to a tree of specs."""
    rules = current_rules()
    return _map_specs(lambda axes: () if rules is None
                      else rules.spec(*axes), logical_tree)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies over a mesh: the mesh and a spec (the counterpart
    of ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple


def _dim_axes(spec, ndim: int) -> list:
    """The mesh axes each of ``ndim`` dimensions is split over (a tuple a
    dimension; a spec shorter than ``ndim`` leaves the rest whole)."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    spec += (None,) * (ndim - len(spec))
    return [() if s is None else (s,) if isinstance(s, str) else tuple(s)
            for s in spec]


def _block(mesh, coords, axes) -> tuple:
    """(block index, block count) of the device at ``coords`` along a
    dimension split over ``axes``, the first axis major."""
    idx, n = 0, 1
    for a in axes:
        k = mesh.axis_names.index(a)
        idx, n = idx * mesh.shape[k] + coords[k], n * mesh.shape[k]
    return idx, n


def shard_tensor(x, mesh, spec) -> list:
    """``x`` cut into its pieces under (``mesh``, ``spec``): one piece a
    device of ``mesh.devices`` (row-major over the mesh), on that device.
    A dimension the spec names is split into equal contiguous blocks over
    its axes; the devices that differ only along axes the spec does not
    name hold the same piece.  On the device where ``x`` lies a piece is a
    view of ``x`` (strided where the split dimension is not the first), so
    one card costs no copy."""
    dims = _dim_axes(spec, x.ndim)
    pieces = []
    for i, dev in enumerate(mesh.devices):
        c = mesh.coords(i)
        piece = x
        for dim, axes in enumerate(dims):
            if axes:
                b, n = _block(mesh, c, axes)
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(x.shape)} "
                                     f"does not split into {n} blocks")
                size = x.shape[dim] // n
                piece = piece.narrow(dim, b * size, size)
        pieces.append(piece.to(dev))
    return pieces


def unshard_tensor(pieces, mesh, spec):
    """The tensor whose pieces under (``mesh``, ``spec``) these are
    (:func:`shard_tensor`), on the first piece's device: each block is
    taken from the first device that holds it."""
    dims = _dim_axes(spec, pieces[0].ndim)
    named = {a for axes in dims for a in axes}
    c0 = mesh.coords(0)
    out = pieces[0].new_empty([s * _block(mesh, c0, axes)[1] for s, axes
                               in zip(pieces[0].shape, dims)])
    for i, piece in enumerate(pieces):
        c = mesh.coords(i)
        if any(c[k] for k, a in enumerate(mesh.axis_names)
               if a not in named):
            continue
        view = out
        for dim, axes in enumerate(dims):
            if axes:
                size = piece.shape[dim]
                view = view.narrow(dim, _block(mesh, c, axes)[0] * size,
                                   size)
        view.copy_(piece)
    return out
