"""Host meshes over the ranks of a ``torch.distributed`` process group
(port of ``repro/launch/mesh.py``).

The JAX package lays a ``("data", "model")`` mesh over its devices; the
port lays it over the ranks of the current process group, world size W
(one rank per process; :mod:`repro_torch.launch.collectives` starts the
group).  With no process group W = 1: the mesh is (1, 1), holds no
group and needs no collective, which is what the JAX package's mesh is
on one device.

The ``"data"`` axis holds the FL clients (cohort members, the production
round's client groups, the ZeRO shards of the f32 master).  The
``"model"`` axis is tensor parallelism inside each client's model: the
ranks ``d * model .. d * model + model - 1`` of data coordinate ``d``
form one model group, each holding its blocks of the leaves that
:mod:`repro_torch.launch.shardings` names ``"model"``.  It runs for the
production round (``core/fl_step.py``) of every family of the zoo, and
for the cohort engine, whose members
(the SER CNN, which the leaf rule does not cut) are replicated over the
model axis: every model rank of a data coordinate runs that
coordinate's members, as the JAX package's engine does, and for serving
(``launch/serve.py``).

:func:`make_production_mesh` gives the JAX package's 16x16 and 2x16x16
production meshes; the second adds a leading ``"pod"`` axis, which joins
``"data"`` as one more data axis (:func:`data_axes`).  Inside a process
group of their size (the fake group of ``launch/dryrun.py``, or a real
one) they are concrete, else abstract.  The dry run takes all the
reference's knobs: ``--remat-policy``, ``--client-placement`` (one
client per rank: ``role="client_all_axes"``, the production round runs
each client whole on its rank) and ``--attn-shard heads_padded`` (head
counts cut first on the model axis, padded where it does not divide
them: ``launch/shardings.py``).
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> "HostMesh":
    """16x16 single pod (256 ranks) or 2x16x16 (2 pods, 512 ranks): over
    the current process group when it has exactly that many ranks (every
    rank must call this then: it builds the axis groups), else
    abstract."""
    pod, data, model = (2, 16, 16) if multi_pod else (1, 16, 16)
    n = pod * data * model
    if dist.is_initialized() and world_size() == n:
        return HostMesh(data, model, world=n,
                        device_mesh=_device_mesh(pod * data, model),
                        pod=pod if multi_pod else None)
    return HostMesh(data, model, pod=pod if multi_pod else None)


def largest_divisor(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k`` (always >= 1)."""
    k = max(1, min(k, n))
    while n % k:
        k -= 1
    return k


def world_size() -> int:
    """The current process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


class HostMesh:
    """A ``("data", "model")`` mesh over ranks ``0 .. data * model - 1`` of
    the process group, or with ``pod`` a ``("pod", "data", "model")``
    mesh over ``pod * data * model`` ranks (rank ``(p * data + d) * model
    + m`` at coordinate (p, d, m)).

    ``shape`` is ``{"data": d, "model": m}`` (with ``"pod"`` first) as on
    a JAX mesh.  ``group``
    is the data axis's process group (None without a process group, and
    on an abstract mesh).  Meshes hash and compare by their axis sizes and
    that group, so a mesh can key the step cache, as in the reference.
    ``world`` is the group's size when the mesh was built; None marks an
    abstract mesh (shape only, as ``jax.sharding.AbstractMesh``), which
    the sharding rules read and nothing runs on.
    """

    def __init__(self, data: int, model: int, world=None, device_mesh=None,
                 pod=None):
        self._sizes = ((int(data), int(model)) if pod is None
                       else (int(pod), int(data), int(model)))
        self.world = world
        self.device_mesh = device_mesh

    @classmethod
    def abstract(cls, data: int, model: int, pod=None) -> "HostMesh":
        return cls(data, model, pod=pod)

    @property
    def axis_names(self) -> tuple:
        return AXES if len(self._sizes) == 2 else POD_AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self._sizes))

    @property
    def group(self):
        """The data axes' process group of this rank (its model
        coordinate's ranks, over the pods too); None without a process
        group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group("data")

    @property
    def model_group(self):
        """The model axis's process group of this rank (its data
        coordinate's ranks); None without a process group."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group("model")

    @property
    def rank(self) -> int:
        """This rank's coordinate on the data axis (0 without a group)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis (0 without a group)."""
        g = self.model_group
        return 0 if g is None else dist.get_rank(g)

    def __eq__(self, other):
        return (type(other) is HostMesh and self._sizes == other._sizes
                and self.world == other.world and self.group is other.group)

    def __hash__(self):
        return hash((HostMesh, self._sizes, self.world, id(self.group)))

    def __repr__(self):
        kind = ("abstract" if self.world is None
                else f"{self.world} rank(s)")
        return f"HostMesh({self.shape}, {kind})"


# one torch DeviceMesh per (axis sizes, process group): building one
# creates process groups, a collective call on every rank
_DEVICE_MESHES: dict = {}


def _device_mesh(data: int, model: int):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.group.WORLD
    stale = [k for k in _DEVICE_MESHES if k[0] is not world]
    for k in stale:
        del _DEVICE_MESHES[k]
    key = (world, data, model)
    if key not in _DEVICE_MESHES:
        # the device type only picks the backend of the sub-groups: gloo
        # ("cpu") for a gloo group, whether its tensors live on the CPU or
        # on a card shared by several ranks
        dtype = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _DEVICE_MESHES[key] = init_device_mesh(
            dtype, (data, model), mesh_dim_names=AXES)
    return _DEVICE_MESHES[key]


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """A mesh over the current process group's ranks.

    Requested axis sizes are clamped to DIVISORS of the world size W
    exactly as the reference clamps them against its device count
    (largest divisor <= the request; ``data=0`` gives 1), then the model
    axis to a divisor of what remains, so ``data * model`` always divides
    W.  A mesh that spans fewer than W ranks can be built and read, but
    running on it raises (:func:`require_runnable`): every rank of the
    group takes part in a run.  With a process group, all its ranks must
    call this (it builds the axis groups when the mesh spans them all).
    """
    n = world_size()
    data = largest_divisor(n, data)
    model = largest_divisor(n // data, model)
    if not dist.is_initialized():
        return HostMesh(data, model, world=1)
    dm = _device_mesh(data, model) if data * model == n else None
    return HostMesh(data, model, world=n, device_mesh=dm)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def num_client_groups(mesh) -> int:
    """The FL client-group axis is pod x data."""
    return int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))


def require_runnable(mesh) -> HostMesh:
    """Raise unless a run can execute on ``mesh``: a concrete mesh over
    the whole current process group."""
    if mesh.world is None:
        raise ValueError(f"{mesh!r} is abstract: it has no ranks to run on")
    n = world_size()
    if mesh.world != n or mesh.size != n:
        raise ValueError(
            f"{mesh!r} spans {mesh.size} of the process group's {n} "
            f"rank(s): a run takes every rank of the group (build the mesh "
            f"with make_host_mesh(data={n}) in every rank)")
    return mesh


def is_writer() -> bool:
    """Whether this process writes a run's host-side files (checkpoints,
    logs): rank 0 of the process group, or the only process.  Every rank
    of a mesh computes the same host state, so one writes it."""
    return not dist.is_initialized() or dist.get_rank() == 0
