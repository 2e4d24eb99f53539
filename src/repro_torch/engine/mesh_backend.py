"""Mesh backend for the cohort engine (port of
``repro/engine/mesh_backend.py``): the client-axis rule and its proof.

The cohort step (:mod:`repro_torch.engine.cohort_step`) stacks every
cohort member on a leading client axis.  On a mesh
(:mod:`repro_torch.launch.mesh`, one rank per process) the rule below
splits that axis over the ranks of the data axis: rank r trains members
``r*K/W .. (r+1)*K/W - 1``, then every rank all-gathers the trained
members in member order (:func:`repro_torch.launch.collectives.
gather_members`), so the merge that follows is the one-process merge.

:class:`CohortSharding` is the piece the engine plumbs end to end: a
hashable rule built from a mesh, used as a step-cache key so sweeps over
one mesh reuse one built step.

Partitioning is shape-aware, as in the reference: :func:`cohort_spec`
partitions a leading dim that is a multiple of the data-axis product and
replicates any other (every rank then trains the whole cohort; nothing
is gathered).  On the engine's default arena path every cohort pads to a
multiple of the data-axis product (``cohort.padded_cohort_size``; pad
members take zero steps and the merge leaves them out), so every cohort
partitions; the host-fed path (``EngineConfig(device_arena=False)``)
replicates uneven cohorts, as the reference does.

:func:`assert_cohort_partitioned` is the proof: each rank held exactly
K / W members of every leaf, and the ranks' rows tile the cohort.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.launch.mesh import (
    data_axes, make_host_mesh, world_size)
# the cohort axis partitions over the same pod x data product that the
# production round calls its client-group axis: one definition, not two
from repro_torch.launch.mesh import num_client_groups as _data_axis_size
from repro_torch.pytree import tree_flatten_with_path


def cohort_mesh(max_cohort: Optional[int] = None):
    """Host mesh for sharded cohorts: every rank on the data axis (clamped
    to a divisor of the world size, and to ``max_cohort`` when given so a
    full cohort maps one member per rank)."""
    n = world_size()
    return make_host_mesh(data=n if max_cohort is None else min(n, max_cohort))


def cohort_spec(mesh, shape) -> tuple:
    """The spec of one cohort-stacked leaf: the leading client dim over
    the ``pod``/``data`` axes when the cohort size divides their product,
    fully replicated (``()``) otherwise."""
    shape = tuple(shape)
    if not shape or shape[0] % _data_axis_size(mesh):
        return ()
    daxes = data_axes(mesh)
    return (daxes if len(daxes) > 1 else daxes[0],) + (None,) * (
        len(shape) - 1)


@dataclass(frozen=True)
class Shard:
    """One rank's rows of a cohort-stacked leaf: ``local`` holds rows
    ``offset .. offset + len(local) - 1`` of a leaf of ``shape``."""

    local: torch.Tensor
    shape: tuple
    offset: int


class CohortSharding:
    """Hashable rule for cohort-stacked trees on a mesh.

    ``rows(k)`` is the range of members this rank trains in a cohort of
    ``k`` (all of them when ``k`` does not partition); the cohort step
    gathers the trained members with :meth:`gather`.

    With ``arch_cfg`` (a model-zoo architecture config) :meth:`spec` also
    names the tensor dims ``launch.shardings.leaf_spec``'s
    ``role="client"`` rule puts on ``model``, exactly the production
    round's stacked layout.  The engine builds it without one, as the
    JAX package's does: on a model axis above 1 the members are
    replicated over the model group, every model rank of a data
    coordinate training the same rows and gathering over its data group.

    Equality/hash key on ``(mesh, arch_cfg)`` so ``cached_cohort_step``
    keeps one built step per mesh.
    """

    def __init__(self, mesh, arch_cfg=None):
        self.mesh = mesh
        self.arch_cfg = arch_cfg

    @property
    def n_data(self) -> int:
        return _data_axis_size(self.mesh)

    def spec(self, shape) -> tuple:
        shape = tuple(shape)
        base = cohort_spec(self.mesh, shape)
        if self.arch_cfg is None or len(shape) < 2:
            return base
        from repro_torch.launch.shardings import leaf_spec
        tensor = leaf_spec(shape, self.arch_cfg, self.mesh, role="client")
        # keep cohort_spec's shape-aware leading dim and graft the tensor
        # dims onto it
        lead = base[0] if len(base) else None
        return (lead,) + tuple(tensor)[1:]

    def partitions(self, k: int) -> bool:
        return bool(cohort_spec(self.mesh, (k,)))

    def rows(self, k: int) -> tuple:
        """``(lo, hi)``: the members of a ``k``-cohort this rank trains."""
        if not self.partitions(k):
            return 0, k
        per = k // self.n_data
        r = self.mesh.rank
        return r * per, (r + 1) * per

    def gather(self, tree):
        """Every rank's trained members, in member order."""
        from repro_torch.launch.collectives import gather_members
        return gather_members(tree, self.mesh.group)

    def record(self, tree, k: int, lo: int):
        """The :class:`Shard` tree of this rank's rows ``lo ..`` of a
        ``k``-cohort."""
        from repro_torch.pytree import tree_map
        return tree_map(lambda l: Shard(l, (k,) + tuple(l.shape[1:]), lo),
                        tree)

    def __eq__(self, other):
        return (type(other) is CohortSharding and self.mesh == other.mesh
                and self.arch_cfg == other.arch_cfg)

    def __hash__(self):
        return hash((CohortSharding, self.mesh, self.arch_cfg))

    def __repr__(self):
        return (f"CohortSharding(mesh={self.mesh.shape}, "
                f"arch_cfg={'set' if self.arch_cfg is not None else None})")


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) and not k.startswith(".")
                   else (k if isinstance(k, str) else f"[{k}]")
                   for k in path)


def assert_cohort_partitioned(tree, mesh) -> dict:
    """Assert every leaf of a cohort-stacked :class:`Shard` tree is
    GENUINELY partitioned on its leading axis: this rank holds exactly
    ``K / data_axis_product`` members of it, and (one all-gather of every
    rank's offsets) the ranks' rows tile ``0 .. K - 1`` in rank order.

    Returns ``{leaf_path: members_per_rank}``.  Raises ``AssertionError``
    naming the first offending leaf: the regression this guards is a
    cohort that stays whole on every rank, which keeps results correct
    while every rank redoes the whole cohort's work.  Every rank of the
    mesh must call it.
    """
    n_data = _data_axis_size(mesh)
    report, offsets = {}, []
    for path, leaf in tree_flatten_with_path(tree):
        name = _keystr(path)
        k = leaf.shape[0]
        if k % n_data:
            raise AssertionError(
                f"{name}: cohort size {k} is not a multiple of the "
                f"data-axis product {n_data} — this shape cannot partition")
        expect = (k // n_data,) + tuple(leaf.shape[1:])
        got = tuple(leaf.local.shape)
        if got != expect:
            raise AssertionError(
                f"{name}: expected this rank to hold {expect} of global "
                f"{tuple(leaf.shape)}, got {got} — the cohort axis is "
                f"replicated, not partitioned")
        report[name] = k // n_data
        offsets.append(leaf.offset)
    if mesh.group is not None and offsets:
        from repro_torch.launch.collectives import all_gather_rows
        mine = torch.tensor([offsets], dtype=torch.int64)
        if torch.device(leaf.local.device).type == "cuda" and \
                torch.distributed.get_backend(mesh.group) == "nccl":
            mine = mine.to(leaf.local.device)
        every = all_gather_rows(mine, mesh.group).cpu()
        for j, (name, per) in enumerate(report.items()):
            want = [r * per for r in range(n_data)]
            if every[:, j].tolist() != want:
                raise AssertionError(
                    f"{name}: the ranks hold rows from "
                    f"{every[:, j].tolist()}, not {want} — the cohort axis "
                    "is not split in rank order")
    return report
