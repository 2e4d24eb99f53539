"""The program walk of one rank's traced run (the port's counterpart of
``repro/analysis/hlo.py``).

The JAX package parses the compiled, scheduled HLO text: it splits the
module into computations, multiplies loop bodies by their trip counts,
and sums dot FLOPs and per-kind collective bytes, converted to per-chip
link traffic with the standard ring multipliers.  The port emits no HLO:
its program is the op-by-op run of one rank, whose matrix-product FLOPs
a ``torch.utils.flop_counter.FlopCounterMode`` counts and whose
collectives :mod:`repro_torch.launch.collectives` counts per call, each
with its input bytes and its group's size.  :func:`analyze` takes those
counts and returns the reference's keys; a loop's trip count needs no
recovering, since every call of a traced loop is counted where it runs.

Ring multipliers (per rank, ``g`` ranks in the call's group, ``b`` the
bytes of this rank's input buffer; the reference states them on output
bytes, which for an all-gather are ``g * b``)::

    all-gather        (g-1)/g * g b  = (g-1) b
    reduce-scatter    (g-1)/g * b
    all-reduce        2 (g-1)/g * b
    broadcast         b              (no reference kind: each rank
                                      receives the buffer once)
    barrier           0

The port makes no all-to-all and no collective-permute.

:func:`donation_aliases` is the counterpart of the reference's alias
table: the pairs of an output and an input that share one storage.
"""
from __future__ import annotations

# collectives.stats() names -> the reference's kinds (the port's
# broadcast and barrier have none and keep their own names)
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "broadcast": "broadcast",
         "barrier": "barrier"}

NOT_PORTED = {
    "hbm_bytes": "the reference counts HBM bytes at XLA's fusion "
                 "boundaries of the compiled program; an eager op-by-op "
                 "count of the port's run is a different quantity and "
                 "does not carry the name",
    "parse_module": "the port emits no HLO text to parse",
    "hlo_ops": "the port emits no HLO text, so it has no HLO op census",
}


def ring_traffic(kind: str, nbytes: float, g: int) -> float:
    """Per-rank link traffic of ``kind`` moving an input of ``nbytes`` on
    a group of ``g`` ranks (module docstring); 0 on a group of one."""
    g = int(g)
    if g < 1:
        raise ValueError(f"group size must be >= 1: {g}")
    ring = (g - 1) / g
    if kind == "all-gather":
        return ring * g * nbytes
    if kind == "reduce-scatter":
        return ring * nbytes
    if kind == "all-reduce":
        return 2 * ring * nbytes
    if kind == "broadcast":
        return float(nbytes) if g > 1 else 0.0
    if kind == "barrier":
        return 0.0
    raise ValueError(f"unknown collective kind {kind!r}")


def analyze(collectives=None, dot_flops: float = 0.0) -> dict:
    """The reference's walk keys for one rank's run.

    ``collectives`` is :func:`repro_torch.launch.collectives.stats` after
    the run (``{name: {"calls", "bytes", "by_group": {g: {"calls",
    "bytes"}}, ...}}``), ``dot_flops`` the run's ``FlopCounterMode``
    total.  ``hbm_bytes`` is None (:data:`NOT_PORTED`)."""
    counts, traffic = {}, {}
    for name, e in (collectives or {}).items():
        kind = KINDS.get(name, name)
        counts[kind] = counts.get(kind, 0) + int(e["calls"])
        t = sum(ring_traffic(kind, v["bytes"], int(g))
                for g, v in e.get("by_group", {}).items())
        traffic[kind] = traffic.get(kind, 0.0) + float(t)
    return {
        "dot_flops": float(dot_flops),
        "hbm_bytes": None,
        "collective_traffic_bytes": traffic,
        "collective_counts": counts,
        "total_collective_bytes": float(sum(traffic.values())),
    }


def _storage_id(t) -> int:
    # the storage object's identity: data_ptr() is 0 for every meta
    # tensor, so two meta tensors could not be told apart by address
    return t.untyped_storage()._cdata


def donation_aliases(inputs, outputs) -> list:
    """``[(output_leaf_index, input_leaf_index), ...]``: each pair of an
    output leaf and an input leaf (flat leaf order of the two trees) that
    share one storage — the port's counterpart of XLA's
    ``input_output_alias`` table.  Works on ``meta`` tensors too.  Keep
    ``inputs`` alive until the call: a freed storage's identity may be
    reused by a new one."""
    import torch
    from repro_torch.pytree import tree_leaves

    def ids(tree):
        return [_storage_id(t) if isinstance(t, torch.Tensor) else None
                for t in tree_leaves(tree)]

    first = {}
    for i, s in enumerate(ids(inputs)):
        if s is not None:
            first.setdefault(s, i)
    return [(o, first[s]) for o, s in enumerate(ids(outputs))
            if s is not None and s in first]


__all__ = ["KINDS", "NOT_PORTED", "analyze",
           "donation_aliases", "ring_traffic"]
