"""Device meshes of the port: one process drives every device of a mesh.

The JAX package builds ``jax.sharding.Mesh``es and runs one body per shard
under ``shard_map`` from a single controller.  The port keeps the single
controller and makes the mesh explicit: a :class:`Mesh` names its axes and
shape and holds a flat, row-major tuple of ``torch.device``s.  A shard's
inputs live on its device, a Python loop runs the body once per shard, and
the collectives of :mod:`repro_torch.distributed.collectives` reduce across
the shards' outputs.

Meshes are made by functions, so importing this module touches no device.
Single pod: 16×16 = 256 devices ``(data, model)``; multi-pod: 2×16×16 =
512 ``(pod, data, model)``, the pod axis an outer data axis for training and
a replica-group axis for serving.  Serving with a sharded page pool carves
a ``kv`` axis out of the data axis (``kv_shards > 1``): each of the
``kv_shards`` groups owns a block of physical KV pages, and split-KV paged
attention merges flash partials across the axis
(:func:`repro_torch.distributed.collectives.split_kv_paged_partial`).

An explicit ``devices`` list may name one device several times: that is how
the CPU tests and one card build an S-shard mesh, the counterpart of the
JAX package's forced host device count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """Axis names, shape, and the devices in row-major order over it."""

    axis_names: tuple
    shape: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) \
                or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coords(self, i: int) -> tuple:
        """The mesh coordinates of ``devices[i]`` (row-major)."""
        out = []
        for n in reversed(self.shape):
            i, r = divmod(i, n)
            out.append(r)
        return tuple(reversed(out))

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis``, every other axis at index 0: shard
        ``s`` of a mesh axis lives on ``axis_devices(axis)[s]``."""
        i = self.axis_names.index(axis)
        stride = math.prod(self.shape[i + 1:])
        return tuple(self.devices[k * stride] for k in range(self.shape[i]))


def _devices(devices, n: int, what: str) -> tuple:
    """The first ``n`` of ``devices``, or of the visible CUDA devices when
    ``devices`` is None; raises when there are fewer."""
    if devices is None:
        visible = torch.cuda.device_count()
        if visible < n:
            raise ValueError(f"{what} but only {visible} devices visible")
        return tuple(torch.device("cuda", i) for i in range(n))
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) < n:
        raise ValueError(f"{what} but only {len(devs)} devices given")
    return devs[:n]


def make_production_mesh(*, multi_pod: bool = False, kv_shards: int = 1,
                         devices=None) -> Mesh:
    if kv_shards > 1:
        if multi_pod:
            raise ValueError("kv sharding + multi-pod not wired yet")
        if 16 % kv_shards:
            raise ValueError(f"kv_shards {kv_shards} does not divide 16")
        shape = (kv_shards, 16 // kv_shards, 16)
        axes = ("kv", "data", "model")
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    return Mesh(axes, shape, _devices(devices, n,
                                      f"the mesh {shape} needs {n} devices"))


def make_kv_mesh(kv_shards: int, *, axis: str = "kv", devices=None) -> Mesh:
    """1-D ``kv`` mesh over the first ``kv_shards`` devices: the serving
    backend's mesh for the sharded page pool (``ModelBackend(kv_shards=N)``).
    With ``devices=None`` it takes ``cuda:0 … cuda:N-1`` and raises when
    fewer cards are visible; pass ``devices=[d] * N`` for N shards on one
    device."""
    return Mesh((axis,), (kv_shards,), _devices(
        devices, kv_shards, f"kv_shards={kv_shards}"))


def data_axes_of(mesh: Mesh) -> tuple:
    """All mesh axes except the tensor-parallel and kv-shard ones."""
    return tuple(a for a in mesh.axis_names if a not in ("model", "kv"))
