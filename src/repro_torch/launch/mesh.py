"""Meshes for the sharded executor, and the hardware constants of the
card the port targets (the counterpart of ``repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
axes.  The port runs SPMD, one process per device: every rank of the
default process group calls the same function with the same arguments
(as a ``torchrun`` program does), so a mesh is built by every rank, and
ranks that a smaller mesh leaves out hold a mesh they are not part of.
The process group comes first, from the caller:
``torch.distributed.init_process_group`` with NCCL for a ``"cuda"``
mesh (rank r on ``cuda:<local rank>``) or gloo for a ``"cpu"`` one.

Axis rules, as in the JAX package: ``model`` shards the sweep operand,
every other axis is data-parallel over sources.

Single pod: (16, 16) = 256 chips, axes (data, model).  Multi-pod:
(2, 16, 16) = 512 chips, axes (pod, data, model).

NVIDIA H100 SXM (``nvidia-smi``: "NVIDIA H100 80GB HBM3, 700.00 W"),
data-sheet rates at the 700 W limit.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

PEAK_FLOPS_BF16 = 989.4e12      # dense BF16 tensor-core FLOP/s per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
NVLINK_BW = 450e9               # NVLink 4 bytes/s per direction per card
                                # (the collective term's link rate)

MODEL_AXIS = "model"

# the backend each mesh device type needs in the default process group
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device) -> str:
    """``None`` means the card; without CUDA that raises, as
    ``graph.csr.resolve_device`` does."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"a mesh lies on 'cuda' or 'cpu', not {dev.type!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' for a CPU mesh")
    return dev.type


class PartitionSpec:
    """How a tensor lies on a mesh, one entry per tensor dimension: ``None``
    (not split), an axis name, or a tuple of axis names (split over those
    axes, the first the major one) — the port's counterpart of
    ``jax.sharding.PartitionSpec``.  Dimensions past the last entry are
    not split; ``PartitionSpec()`` replicates the whole tensor."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"PartitionSpec{self.parts!r}"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device=None, ranks: Optional[Sequence[int]] = None):
    """A mesh of ``shape`` with axis names ``axes`` over ``ranks`` (the
    first ``prod(shape)`` ranks of the default group by default), on
    ``device`` (``None``: the card; ``"cpu"`` for a gloo mesh).  Every
    rank of the default group must call it.  On a ``"cuda"`` mesh each
    rank first selects ``cuda:<local rank>`` (``LOCAL_RANK``, else the
    global rank modulo the visible cards)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    kind = _device_type(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up "
                         f"one to one")
    if not dist.is_initialized():
        raise RuntimeError(
            "no default process group: every rank calls "
            "torch.distributed.init_process_group first (NCCL for a 'cuda' "
            "mesh, gloo for a 'cpu' one)")
    backend = dist.get_backend()
    if _BACKENDS[kind] not in backend:
        raise ValueError(f"a {kind!r} mesh needs {_BACKENDS[kind]} in the "
                         f"default group, which runs {backend!r}")
    size = 1
    for s in shape:
        size *= s
    ranks = list(range(size)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != size:
        raise ValueError(f"a {shape} mesh needs {size} ranks, got "
                         f"{len(ranks)}")
    if size > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {size} ranks, the default "
                         f"group has {dist.get_world_size()}")
    if kind == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(kind, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh: (16, 16) ``(data, model)``, or (2, 16, 16)
    ``(pod, data, model)``.  Needs 256 or 512 ranks and raises without
    them, as JAX does without the devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_test_mesh(n_devices: Optional[int] = None, model: int = 2, *,
                   device=None):
    """A small ``(data, model)`` mesh over ``n_devices`` ranks (the whole
    default group by default) — tests only."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model}")
    return make_mesh((n // model, model), ("data", "model"), device=device)


def mesh_from_plan(plan, devices: Optional[Sequence[int]] = None, *,
                   device=None):
    """The mesh of a fault-tolerance
    :class:`repro_torch.train.fault_tolerance.ElasticPlan` over the ranks
    alive now — the elastic-restart walk is ``plan_remesh(alive_chips,
    ...)`` → ``mesh_from_plan(plan)`` → ``checkpoint.restore(...,
    shardings=)``.

    Builds the mesh over the first ``plan.n_chips`` of ``devices`` (global
    ranks; the whole default group by default), reshaped to
    ``plan.mesh_shape`` with ``plan.axis_names``: a shrunken plan works in
    the same process group that drove the larger mesh, and the ranks it
    leaves out hold a mesh they are not part of."""
    import torch.distributed as dist
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if len(ranks) < plan.n_chips:
        raise ValueError(f"elastic plan needs {plan.n_chips} devices, only "
                         f"{len(ranks)} visible")
    return make_mesh(plan.mesh_shape, plan.axis_names, device=device,
                     ranks=ranks[: plan.n_chips])


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: every axis not named ``model``."""
    return tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)


def dp_size(mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh_extent(mesh, a)
    return out


def mesh_extent(mesh, axis: str) -> int:
    """The size of axis ``axis`` (1 for an axis the mesh lacks)."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the CPU, or the card it selected."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_mesh(mesh) -> None:
    """``mesh`` is a DeviceMesh with named axes that holds this rank
    (``ValueError`` otherwise: a foreign mesh object, or a rank that a
    smaller mesh left out)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise ValueError(
            f"mesh= takes a torch.distributed DeviceMesh with named axes "
            f"(repro_torch.launch.mesh.make_mesh), not "
            f"{type(mesh).__name__}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not part of the mesh: only the "
                         "mesh's ranks may use it")


def check_mesh_device(mesh, device) -> None:
    """A ``mesh=`` passed to a caller that holds its own ``device`` must
    pass :func:`check_mesh` and lie on that kind of device: the port
    moves nothing between the card and the CPU on its own."""
    check_mesh(mesh)
    kind = mesh.device_type
    if kind != torch.device(device).type:
        raise ValueError(f"the mesh lies on {kind!r}, the caller on "
                         f"{torch.device(device)}: build the mesh on the "
                         f"caller's device")
