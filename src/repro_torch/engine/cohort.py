"""Cohort formation and weight algebra for the async execution engine.

A *cohort* is the set of client completion events popped from the virtual-
clock priority queue whose completion times fall within a staleness-
tolerance window of the earliest pending event (FedBuff-style batching,
Nguyen et al.; PAPERS.md).  The whole cohort runs through ONE compiled
vmapped local-phase step instead of one Python-level step per client per
minibatch.

``fold_cohort_weights`` turns the strategy's per-member mixing weights
(e.g. FedAsync's alpha/(1+tau_i), paper Eq. 10-11) into an exactly
equivalent single linear combination

    g' = g_coeff * g + sum_i coeffs[i] * p_i

of the old globals and the cohort members' uploads, so a K-member cohort
merge is ONE fused weighted reduction over the stacked client axis yet
produces the same result as K sequential ``tree_lin`` merges.

Pure-numpy copy of ``repro/engine/cohort.py``, held bitwise equal by the
parity tests.  In the port ``LocalRoundPlan.key`` holds the member's
integer dispatch seed (it seeds the member's noise generator) instead of
a JAX PRNG key.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class LocalRoundPlan:
    """Everything needed to replay one client's local round inside the
    compiled cohort step, captured at dispatch time (the client trains on
    the globals it pulled, not the globals at completion — that gap IS the
    staleness the paper measures)."""

    cid: int
    params0: object          # globals (+ personal overlay) pulled at dispatch
                             # (None on the arena path: the snapshot lives in
                             # the client's device-resident arena slot)
    opt_state: object        # client optimizer state at dispatch (None on
                             # the arena path — state never leaves the arena)
    batch_idx: np.ndarray    # (S, B) int32 minibatch indices into c.data
                             # (None until staging: dispatch defers the
                             # permutation draws — O(1) per client — and
                             # CohortRunner._materialize_plans fills it)
    key: object              # dispatch PRNG key (the legacy local_train sub)
    n_steps: int             # S actually executed (== legacy DP-SGD steps)
    duration: float          # virtual round duration from the tier clock
    epsilon: float           # accountant epsilon AFTER this round's steps
    model_version: int       # server version the client pulled from
    t_complete: float = 0.0
    personal_snapshot: Optional[dict] = None  # received globals at personal keys
    dropped: bool = False    # update lost to a fault (core.faults): the member
                             # stays in the compiled cohort as a zero-weight
                             # mask slot and is never logged as an update
    corrupt_scale: float = 1.0  # transit-corruption payload scale drawn by the
                                # FaultInjector at delivery (1.0 = clean
                                # sentinel, NaN = all-NaN payload, else delta
                                # blowup) — folded into the compiled step's
                                # (K_pad,) runtime corrupt_scale vector


def steps_per_round(n: int, batch_size: int, local_epochs: int) -> int:
    """Number of full minibatch steps one local round executes — the
    single source of truth shared by :func:`plan_batches` and the
    engine's padded step count (they must agree or cohort stacking
    produces mismatched shapes)."""
    per_epoch = ((n - batch_size) // batch_size + 1) if n >= batch_size else 0
    return local_epochs * max(0, per_epoch)


def plan_batches(rng: np.random.Generator, n: int, batch_size: int,
                 local_epochs: int) -> np.ndarray:
    """Replicate the legacy minibatch schedule exactly: per epoch, one
    permutation consumed in contiguous ``batch_size`` slices, dropping the
    ragged tail (``range(0, n - B + 1, B)``).  Returns (S, B) indices."""
    per_epoch = []
    steps = steps_per_round(n, batch_size, 1)
    for _ in range(local_epochs):
        perm = rng.permutation(n)
        if steps:
            per_epoch.append(
                perm[: steps * batch_size].reshape(steps, batch_size))
    if not per_epoch:
        return np.zeros((0, batch_size), np.int32)
    return np.concatenate(per_epoch, axis=0).astype(np.int32)


def pop_cohort(heap: list, window: float, max_size: int,
               bucket_pow2: bool = False):
    """Pop the earliest event plus every event within ``window`` virtual
    seconds of it (up to ``max_size``), in stable ``(time, cid)`` order.

    Tie-breaking is a GUARANTEE, not an accident of heap layout: events
    completing at the same virtual time come off in ascending cid, so a
    cohort's membership and member order — and therefore the pipelined
    scheduler's lookahead plans, the fold of the merge weights and every
    downstream RunLog row — are reproducible across runs and across
    ``pipeline_depth`` settings.  (Entries are ``(time, cid)`` tuples, so
    the heap already yields that order; the explicit sort pins the
    contract against any future entry shape that compares differently.)

    With ``bucket_pow2`` the cohort is truncated to the largest power of
    two <= its natural size (the tail goes back on the heap): the compiled
    cohort step then only ever sees K in {1, 2, 4, ...}, bounding XLA
    recompiles without wasting compute on padded dummy members."""
    events = [heapq.heappop(heap)]
    t0 = events[0][0]
    while heap and len(events) < max_size and heap[0][0] <= t0 + window:
        events.append(heapq.heappop(heap))
    events.sort()  # deterministic (time, cid) order even on time ties
    if bucket_pow2:
        keep = 1 << (len(events).bit_length() - 1)
        for ev in events[keep:]:
            heapq.heappush(heap, ev)
        events = events[:keep]
    return events


def padded_cohort_size(k: int, n_data: int = 1, pow2: bool = True) -> int:
    """Leading dim of the compiled step for a K-member cohort: the pow2
    bucket >= K, rounded up to a multiple of the mesh data-axis product
    ``n_data`` so the stacked cohort ALWAYS partitions under GSPMD (which
    silently replicates uneven leading-dim constraints).  Pad members are
    zero-weight masked — ``n_steps=0`` in the compiled step, coefficient 0
    in ``merge_cohort`` — so the result is bit-identical to the unpadded
    cohort while the recompile set collapses to the bucket sizes.

    ``pow2`` mirrors ``EngineConfig.pow2_cohorts``: with bucketing off the
    pad goes straight to the MINIMAL multiple of ``n_data`` — pad members
    still execute the masked local phase, so rounding 5 up through 8 to a
    12 on a 6-way axis would double the device work the user asked to
    avoid."""
    kp = (1 << max(0, k - 1).bit_length()) if pow2 else k
    if n_data > 1:
        kp = -(-kp // n_data) * n_data
    return kp


def fold_cohort_weights(ws) -> tuple:
    """Fold sequential async merges into one linear combination.

    K sequential merges g <- (1 - w_i) g + w_i p_i (paper Eq. 11) equal

        g' = prod_i (1 - w_i) * g  +  sum_i [ w_i * prod_{j>i} (1 - w_j) ] p_i

    Returns ``(g_coeff, coeffs)`` with ``coeffs`` a float64 (K,) vector.
    ``g_coeff + coeffs.sum() == 1`` (convexity) whenever all w_i in [0, 1].
    """
    ws = np.asarray(ws, dtype=np.float64)
    coeffs = np.empty_like(ws)
    rest = 1.0
    for i in range(len(ws) - 1, -1, -1):
        coeffs[i] = ws[i] * rest
        rest *= 1.0 - ws[i]
    return float(rest), coeffs


def fedavg_weights(sizes) -> tuple:
    """FedAvg (paper Eq. 9): dataset-size weights, globals fully replaced."""
    sizes = np.asarray(sizes, dtype=np.float64)
    return 0.0, sizes / sizes.sum()
