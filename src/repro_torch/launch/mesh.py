"""Meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``.  Axis semantics are the
reference's: ``model`` = tensor/expert parallelism, ``data`` = data/FSDP
parallelism, ``pod`` = the DCN axis (one gradient all-reduce a step, or
pipeline handoffs).  A mesh here is a
:class:`torch.distributed.device_mesh.DeviceMesh` with ``mesh_dim_names``
laid over the process group the caller has already initialized
(``torch.distributed.init_process_group``: gloo for CPU tensors, nccl for
cards).  Nothing here initializes a group, and nothing falls back to one
device: without a group, or with a group whose world size is not the
product of the shape, a builder raises.  Functions, not module
constants — importing this module touches no process group.

Throughout the port ``mesh=None`` is the one-device case with no process
group (``Runtime(bundle, device)``, ``make_train_step(bundle, tcfg)``).
A mesh's per-axis groups are ``mesh.get_group(axis)`` and a rank's
coordinate on an axis ``mesh.get_local_rank(axis)``: the tensor-parallel
layers reduce over the ``model`` group, the training step over the
``data`` and ``pod`` groups (``models/sharding.py`` realizes the specs).
``init_device_mesh`` makes every axis's group on every rank at
construction, so each rank must build the same mesh.

**Donor axes** (the paper's peer-memory experiments, Figs. 15-17): an axis
named :data:`DONOR_AXIS` or :data:`REMOTE_DONOR_AXIS` marks ranks whose
memory is donated to the computation.  :func:`make_donor_mesh` builds such
a mesh, but nothing in the port consumes it yet: the peer and remote
placements that would shard across it are ROADMAP A10c.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.placement import DONOR_AXIS, REMOTE_DONOR_AXIS  # noqa: F401


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under nccl, ``cpu`` otherwise."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh_compat(devices_shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``devices_shape`` named ``axes`` over the
    initialized default process group (ranks in row-major order).

    Raises when no group is initialized, when shape and names differ in
    length, or when the group's world size is not the shape's product.
    """
    shape, axes = tuple(int(d) for d in devices_shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} do not pair up")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh over {axes} needs an initialized process group "
            "(torch.distributed.init_process_group, e.g. under torchrun); "
            "mesh=None is the one-device case")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} over {axes} has {math.prod(shape)} ranks, "
                         f"but the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production shapes: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


def make_mesh_for(devices_shape: tuple[int, ...], axes: tuple[str, ...]):
    """Arbitrary mesh (tests, the launcher)."""
    return make_mesh_compat(devices_shape, axes)


def make_donor_mesh(
    compute_shape: tuple[int, ...] = (1,),
    compute_axes: tuple[str, ...] = ("data",),
    donor_size: int = 2,
    *,
    remote: bool = False,
):
    """Compute mesh with a leading donor axis of ``donor_size`` slices:
    :data:`DONOR_AXIS`, or :data:`REMOTE_DONOR_AXIS` with ``remote=True``;
    ``donor_size * prod(compute_shape)`` ranks.  Built, not consumed: no
    placement of the port shards across a donor axis yet (ROADMAP A10c)."""
    axis = REMOTE_DONOR_AXIS if remote else DONOR_AXIS
    if donor_size < 2:
        raise ValueError(f"donor axis needs >= 2 slices, got {donor_size}")
    return make_mesh_compat((donor_size, *compute_shape), (axis, *compute_axes))


def mesh_axes_dict(mesh) -> dict[str, int]:
    """{axis name: size}; ``{}`` for ``mesh=None``."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``: 1 for ``mesh=None`` or a mesh without it."""
    return mesh_axes_dict(mesh).get(axis, 1)
