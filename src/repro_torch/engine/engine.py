"""Cohort-batched async execution engine (port of
``repro/engine/engine.py``).

The event loop is the reference's: dispatch plans each client's local
round on the host (clock draw, accountant step, version pull), cohorts
pop off the virtual-clock heap within ``staleness_window`` of the
earliest completion, each cohort runs as one cohort step
(:mod:`repro_torch.engine.cohort_step`), and FedAvg/FedAsync weights
fold into one weights-vector merge, while FedBuff, AdaptiveAsync, the
robust strategies and personalized clients go member by member through
``aggregation.apply_update`` / ``strategy.aggregate`` — the switch the
legacy loop uses.  RunLog bookkeeping is host-deterministic and equals
the reference's.

Data paths (``EngineConfig.device_arena``): the default arena path keeps
the clients' params and optimizer state in stacked device arenas and
every distinct dataset on the device once (:class:`DataArena`), so a
cohort's only upload is a few KB of index plans; the host-fed path
(``device_arena=False``) stacks each cohort's params, optimizer states
and batches on the host side and writes each member's optimizer state
back to its client.  ``StoreConfig(hot_slots=...)`` bounds the arena to
a hot set backed by a host cold store
(:mod:`repro_torch.engine.statestore`).

Scheduling (``EngineConfig.pipeline_depth``): a cohort is staged (lazy
batch plans drawn, index plans copied to the card from pinned buffers
without blocking) and then submitted (the step and merge enqueued on the
stream).  Depth 1 is the serial driver: each cohort is waited for
before the next one is staged (``blocking_submits``).  Depth >= 2 keeps
up to that many cohorts in flight; past it the loop waits on the oldest
cohort's CUDA event (``drain_waits``), and the host blocks only at
evals, screen-verdict fetches and store spills, each counted in its own
bucket, so ``host_syncs_between_evals`` is 0.  Everything runs on one stream in the
serial order, so a pipelined run is bit-identical to the serial one.

Faults and screening (RESILIENCE.md): a ``FaultInjector`` resolves every
popped completion (or FedAvg delivery) on the host; a lost update stays
in its cohort as a zero-weight member, and each delivered member's
transit-corruption scale rides into the step's runtime (K,) scale
vector.  Screening compares the step's per-member (finite, norm) outputs
with the thresholds on the host, after one counted fetch per cohort
(``screen_verdict_syncs``).  Neither changes the built step.

Checkpoint/resume (:mod:`repro_torch.engine.resilience`): the loops
snapshot at loop-consistent points and resume bit-identically.

Randomness: dispatch seeds come from ``np.random.default_rng(seed)`` in
the order the reference splits its PRNG key — N at startup, then one per
re-dispatch (async) or one per client per round (FedAvg).  Each seed
seeds that member's device ``torch.Generator`` for its DP noise, unless
the runner was given ``noise_streams``, a factory ``dispatch seed ->
source`` whose callables ``source(step, leaf, shape)`` the cohort step
draws from instead, as the production round does (the parity tests hand
in the JAX package's draws this way; no spec or Session sets it).

Executors (``EngineConfig.client_axis``): ``"unroll"``, ``"map"``,
``"vmap"`` and ``"fl_step"``, the production round's local phase driven
from the event loop with ``EngineConfig.fl_cfg``
(:mod:`repro_torch.engine.cohort_step`).

Mesh execution (``EngineConfig.mesh``, a
:func:`repro_torch.launch.mesh.make_host_mesh` mesh over the process
group's ranks): every rank runs this loop, its host bookkeeping
(scheduler, accountant, RunLog, faults, screen, store decisions) alike
on every rank, and each cohort's members split over the data axis
(:mod:`repro_torch.engine.mesh_backend`).  On the arena path cohorts pad
to a multiple of the data-axis product (``cohort.padded_cohort_size``;
pad members take zero steps from the pad row and the merge leaves them
out) and the client-state arena's row count rounds up to one.  Member
generators are seeded by dispatch seed, so a member's noise does not
depend on the rank it lands on.  On a model axis above 1 the members
(the SER CNN) are replicated over the model axis, as in the JAX
package's engine: every model rank of a data coordinate trains that
coordinate's members, gathers over its data group only, and holds the
run of the data-axis-only mesh of the same data width, bit for bit;
rank 0 of the process group alone writes a snapshot.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import accountant as _accountant
from repro_torch.core.aggregation import (
    AdaptiveAsync, FedAsync, FedAvg, FedBuff, apply_update)
from repro_torch.core.client import SEED_HIGH
from repro_torch.core.faults import (
    FaultInjector, apply_deadline, zero_fault_stats)
from repro_torch.core.runlog import (
    RunLog, eval_all, finish_log, validate_engine_stats)
from repro_torch.core.screening import ScreeningState, zero_screen_stats
from repro_torch.engine.cohort import (
    LocalRoundPlan, fedavg_weights, fold_cohort_weights, padded_cohort_size,
    plan_batches, pop_cohort, steps_per_round)
from repro_torch.engine.cohort_step import (
    cached_cohort_step, put_rows_, stack_trees, take_rows, unstack_tree,
    validate_client_axis)
from repro_torch.engine.statestore import (
    DataArena, StoreConfig, TieredStateStore, _tree_nbytes, zero_store_stats)
from repro_torch.engine.mesh_backend import CohortSharding
from repro_torch.kernels.common import kernel_info
from repro_torch.launch.mesh import num_client_groups, require_runnable
from repro_torch.pytree import tree_leaves, tree_map


@dataclass(frozen=True)
class EngineConfig:
    """The reference's fields, defaults and validation.  ``mesh`` is a
    :class:`repro_torch.launch.mesh.HostMesh`; the runner refuses one it
    cannot run (a model axis above 1, or fewer ranks than the group)."""

    staleness_window: float = 0.0  # virtual seconds of completions per cohort
    max_cohort: int = 2            # cap on popped cohort size
    fused_merge: bool = True       # fold FedAvg/FedAsync into the weights vector
    delta: float = 1e-5            # accountant delta
    client_axis: str = "unroll"
    pow2_cohorts: bool = True      # bucket cohort sizes (K in {1, 2, 4, ...})
    mesh: Optional[object] = None
    fl_cfg: Optional[object] = None
    device_arena: bool = True      # False: the host-fed data path
    pipeline_depth: int = 1        # cohorts in flight (1: the serial driver)
    store: StoreConfig = StoreConfig()  # hot_slots bounds the device arena

    def __post_init__(self):
        validate_client_axis(self.client_axis)
        if int(self.pipeline_depth) < 1 or self.pipeline_depth != int(
                self.pipeline_depth):
            raise ValueError(
                f"pipeline_depth must be an integer >= 1: "
                f"{self.pipeline_depth!r}")
        if self.store.hot_slots is not None:
            if not self.device_arena:
                raise ValueError(
                    "StoreConfig.hot_slots requires device_arena=True — "
                    "the host data path has no device arena to bound")
            if self.store.hot_slots < self.max_cohort:
                raise ValueError(
                    f"StoreConfig.hot_slots={self.store.hot_slots} must be "
                    f">= max_cohort={self.max_cohort}: a staged cohort pins "
                    "one hot slot per member, so a smaller hot set "
                    "deadlocks slot acquisition")
        if self.max_cohort < 1:
            raise ValueError(f"max_cohort must be >= 1: {self.max_cohort}")


def _resolve_cfg(engine_cfg, mesh) -> EngineConfig:
    """Fold a frontend-supplied mesh into the config."""
    cfg = engine_cfg or EngineConfig()
    if mesh is not None and cfg.mesh is None:
        cfg = replace(cfg, mesh=mesh)
    return cfg


def _host_fetch(runner, value) -> float:
    """The funnel for the loops' device->host scalar reads."""
    out = float(value)
    runner.note_host_sync()
    return out


def _to_host(tree):
    """A host copy of a tree of tensors: pinned buffers filled by
    asynchronous copies and one wait on the card, plain clones on the
    CPU."""
    if tree_leaves(tree)[0].device.type != "cuda":
        return tree_map(lambda l: l.detach().clone(), tree)

    def fetch(l):
        dst = torch.empty(l.shape, dtype=l.dtype, pin_memory=True)
        dst.copy_(l, non_blocking=True)
        return dst

    out = tree_map(fetch, tree)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _host_fetch_array(runner, value):
    """The :func:`_host_fetch` sibling for tensor reads: a cohort's screen
    verdicts (bucketed as ``screen_verdict_syncs``) and the store's spills
    (``store_sync_reads``).  Returns the tree as host tensors."""
    out = _to_host(value)
    runner.note_host_sync()
    return out


class _PinnedStaging:
    """Host->device copies without a host wait: each upload packs its
    arrays into one pinned buffer, copies it with ``non_blocking=True``
    and records a CUDA event; a buffer is reused only after its event has
    completed, so the pool settles at the number of copies in flight
    (about ``pipeline_depth + 1`` cohorts' worth).  A copy from pageable
    memory would wait for the stream to drain: a hidden host sync per
    cohort."""

    ALIGN = 16

    def __init__(self, device):
        self.device = device
        self.bufs = []            # [pinned uint8 buffer, event or None]

    def _buffer(self, nbytes: int):
        # best fit: a small upload must not take the buffer that the next
        # cohort's batches need
        free = [e for e in self.bufs if e[0].numel() >= nbytes
                and (e[1] is None or e[1].query())]
        if free:
            return min(free, key=lambda e: e[0].numel())
        entry = [torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                             pin_memory=True), None]
        self.bufs.append(entry)
        return entry

    def upload(self, arrays) -> list:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // self.ALIGN) * self.ALIGN
        entry = self._buffer(max(total, 1))
        host = entry[0].numpy()
        for a, off in zip(arrays, offs):
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = entry[0][:max(total, 1)].to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        entry[1] = ev
        out = []
        for a, off in zip(arrays, offs):
            dt = torch.from_numpy(a[:0]).dtype
            out.append(dev[off:off + a.nbytes].view(dt).view(a.shape))
        return out


@dataclass
class StagedCohort:
    """One cohort's device inputs, assembled and copied ahead of
    submission: on the arena path the index plans, on the host path the
    stacked state and batch tensors."""

    plans: list
    k: int
    degenerate: bool = False       # s_max == 0: no client has a full batch
    arena: bool = True
    slots: Optional[torch.Tensor] = None       # (K,) int64 state slots
    data_slots: Optional[torch.Tensor] = None  # (K,) int64 dataset rows
    batch_idx: Optional[torch.Tensor] = None   # (K, S_max, B) int64
    n_steps: Optional[np.ndarray] = None       # (K,) host int32
    live_steps: Optional[torch.Tensor] = None  # (K,) int32 on the device
    corrupt: Optional[torch.Tensor] = None     # (K,) f32 corruption scales
    stacked_params: Optional[object] = None    # host path only
    stacked_opt: Optional[object] = None
    batches: Optional[dict] = None


class CohortRunner:
    """Owns the cohort step, the device arenas, the tiered store and the
    host plan glue."""

    def __init__(self, clients, cfg: EngineConfig, device, data_arena=None,
                 noise_streams=None):
        c0 = clients[0]
        for c in clients:
            if (c.dp_cfg != c0.dp_cfg or c.use_dp != c0.use_dp
                    or c.dp_path != c0.dp_path or c.opt != c0.opt
                    or c.batch_size != c0.batch_size
                    or not (c.loss_fn is c0.loss_fn
                            or c.loss_fn == c0.loss_fn)):
                raise ValueError(
                    "cohort engine requires homogeneous client training "
                    "configs (heterogeneity lives in the virtual clocks)")
        self.clients = clients
        self.cfg = cfg
        self.device = torch.device(device)
        # dispatch seed -> a member's noise stream (None: its generator)
        self.noise_streams = noise_streams
        self.s_max = max(
            steps_per_round(c.n_train, c.batch_size, c.local_epochs)
            for c in clients)
        self.use_arena = bool(cfg.device_arena)
        self.tiered = self.use_arena and cfg.store.hot_slots is not None
        self.pipelined = cfg.pipeline_depth > 1
        # the serial driver consumes every cohort before staging the next
        self._submits_block = not self.pipelined
        if cfg.client_axis == "fl_step" and c0.use_dp:
            # the host-side accountant (dispatch) charges the clients'
            # dp_cfg mechanism: eps depends on (q, sigma, steps) — the
            # sampling rate and step count are the same either way and
            # eps is clip-norm-independent, so the bound transfers to the
            # executed per-microbatch mechanism ONLY when the noise
            # multipliers agree and noise is actually added per step
            fl_dp = cfg.fl_cfg.dp if cfg.fl_cfg is not None else None
            if (fl_dp is None or fl_dp.granularity != "per_microbatch"
                    or fl_dp.noise_multiplier != c0.dp_cfg.noise_multiplier):
                raise ValueError(
                    "client_axis='fl_step' with DP clients requires "
                    "fl_cfg.dp to use granularity='per_microbatch' with the "
                    "same noise_multiplier as the clients' dp_cfg "
                    f"(got {fl_dp!r} vs sigma={c0.dp_cfg.noise_multiplier}) "
                    "— otherwise the reported epsilon does not describe "
                    "the executed mechanism")
        add_noise = bool(c0.use_dp and c0.dp_cfg.noise_multiplier > 0)
        self.dp_path = c0.dp_path if c0.use_dp else "jnp"
        # the mesh: members split over the data axis of the process group
        # and replicated over a model axis (no group, W = 1: the
        # one-process step); arena cohorts pad to a
        # multiple of the data-axis product (reference engine.py:368-374)
        self.mesh = cfg.mesh
        self.sharding = None
        self._n_data = 1
        if self.mesh is not None:
            require_runnable(self.mesh)
            if self.mesh.group is not None:
                self.sharding = CohortSharding(self.mesh)
            if self.use_arena:
                self._n_data = num_client_groups(self.mesh)
        self.last_partition = None
        self.cohort_step, self.merge_cohort = cached_cohort_step(
            c0.loss_fn, c0.dp_cfg, c0.opt, use_dp=c0.use_dp,
            dp_path=self.dp_path, add_noise=add_noise, arena=self.use_arena,
            client_axis=cfg.client_axis, fl_cfg=cfg.fl_cfg,
            sharding=self.sharding)
        # runtime noise scale sigma*C/B: float64 on the host, rounded once
        # to float32 (reference engine.py:360), then one device element
        self._noise_std = torch.tensor(
            [np.float32(c0.dp_cfg.noise_multiplier * c0.dp_cfg.clip_norm
                        / c0.batch_size if c0.use_dp else 0.0)],
            dtype=torch.float32, device=self.device)
        self._eps_sched = {}
        self._staging = (_PinnedStaging(self.device)
                         if self.device.type == "cuda" else None)
        self._side = None              # the store's prefetch copy stream
        self.store = None
        self.data_arena = None
        if self.use_arena:
            self._adopt_data_arena(data_arena)
        self.reset_for_run()

    def reset_for_run(self):
        """Drop per-run state (client-state arenas, queued writes, the
        store's residency, fault and screening oracles, counters); the
        dataset arena, the step and the epsilon schedules survive (the
        Session reuses a runner across runs)."""
        from repro_torch.kernels.dp_clip import dp_clip
        self._arena_params = None
        self._arena_opt = None
        self._writeq = []
        self.cohorts_run = 0
        self.h2d_bytes_total = 0
        self._in_eval = False
        self.host_syncs_at_eval = 0
        self.host_syncs_between_evals = 0
        self.blocking_submits = 0
        self.drain_waits = 0
        self.fault_injector = None
        self.screening = None
        self._in_screen = False
        self.screen_verdict_syncs = 0
        self._last_screen = None
        self._serial_done = None
        self._in_store = False
        self._launches0 = dp_clip.launches()
        if self.tiered:
            self.store = TieredStateStore(
                self.cfg.store, len(self.clients), self)

    # -- host-sync accounting ---------------------------------------------
    def note_host_sync(self):
        if self._in_store:
            self.store.sync_reads += 1
        elif self._in_screen:
            self.screen_verdict_syncs += 1
        elif self._in_eval:
            self.host_syncs_at_eval += 1
        else:
            self.host_syncs_between_evals += 1

    def eval_boundary(self, inside: bool):
        self._in_eval = inside

    # -- host->device staging and the in-flight window ---------------------
    def _h2d(self, *arrays) -> list:
        """Copy host arrays to the device: through pinned staging on the
        card (no host wait), as fresh tensors on the CPU."""
        if self._staging is None:
            return [torch.from_numpy(np.array(a)) for a in arrays]
        return self._staging.upload(arrays)

    def cohort_done(self):
        """A marker of everything enqueued so far: a CUDA event on the
        card, None on the CPU (where every op has already run)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _await_serial(self):
        """The serial driver's wait for its previous cohort."""
        done, self._serial_done = self._serial_done, None
        if done is not None:
            done.synchronize()

    def drain(self, inflight: deque):
        """Backpressure: wait on the oldest in-flight cohort's event until
        at most ``pipeline_depth`` cohorts are in flight."""
        while len(inflight) > self.cfg.pipeline_depth:
            self.drain_waits += 1
            ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    # -- device-resident arenas -------------------------------------------
    def _adopt_data_arena(self, data_arena):
        """Size the client-state arena (``hot_slots`` rows under the store,
        all N otherwise) and adopt, or build, the dataset arena.  On the
        all-resident layout with distinct datasets both index spaces
        coincide (slot == cid == data row) and staging uploads one slot
        vector."""
        n = len(self.clients)
        if data_arena is None:
            data_arena = DataArena.build(self.clients, self.device)
        self.data_arena = data_arena
        self._arena_data = data_arena.leaves
        self._data_slot_of = data_arena.slot_of_cid
        hot = self.cfg.store.hot_slots if self.tiered else n
        # plus the pad row, gathered by a mesh's pad members, and rounded
        # up to a multiple of the data-axis product (reference
        # engine.py:500-504): both arenas' shapes, and so the snapshot
        # arrays and the store's byte counts, are the reference's
        self.pad_slot = hot
        slots = hot + 1
        if self._n_data > 1:
            slots = -(-slots // self._n_data) * self._n_data
        self.arena_slots = slots
        self._data_slots_identical = (
            not self.tiered and data_arena.pad_slot == self.pad_slot
            and np.array_equal(self._data_slot_of, np.arange(n)))

    def _ensure_state_arenas(self, params):
        if self._arena_params is not None:
            return
        a = self.arena_slots
        self._arena_params = tree_map(
            lambda l: l.detach().unsqueeze(0).repeat(
                (a,) + (1,) * l.dim()).contiguous(), params)
        self._arena_opt = self.clients[0].opt.init(
            self._arena_params, stack_shape=(a,))

    def _queue_write(self, slot: int, params_tree):
        """Deferred 'slot trains from this params tree': consecutive
        dispatches sharing one globals object collapse into one write."""
        self._ensure_state_arenas(params_tree)
        self._writeq.append((slot, params_tree))

    def _cancel_writes(self, slot: int):
        """Drop queued writes against ``slot`` (its occupant was evicted;
        the replacement queues its own)."""
        self._writeq = [(s, t) for s, t in self._writeq if s != slot]

    def _flush_writes(self):
        q, self._writeq = self._writeq, []
        groups = []
        i = 0
        while i < len(q):
            tree = q[i][1]
            slots = [q[i][0]]
            j = i + 1
            while j < len(q) and q[j][1] is tree:
                slots.append(q[j][0])
                j += 1
            groups.append((tree, slots))
            i = j
        if not groups:
            return
        idxs = self._h2d(*[np.asarray(sl, np.int64) for _, sl in groups])
        for (tree, slots), idx in zip(groups, idxs):
            n = len(slots)
            tree_map(lambda a, l: a.index_copy_(
                0, idx, l.unsqueeze(0).expand((n,) + l.shape)),
                self._arena_params, tree)

    # -- tiered-store device plumbing (repro_torch.engine.statestore) ------
    def spill_opt_slot(self, slot: int):
        """Fetch one hot opt row to the host for the cold store, through
        the ``_host_fetch_array`` funnel (counted ``store_sync_reads``).
        The copy is enqueued on the main stream, after every in-flight
        cohort that trains the row."""
        idx = self._h2d(np.asarray([slot], np.int64))[0]
        row = take_rows(self._arena_opt, idx)
        self._in_store = True
        try:
            host = _host_fetch_array(self, row)
        finally:
            self._in_store = False
        return tree_map(lambda l: l[0], host)

    def load_opt_rows(self, rows, slots):
        """Cold opt rows back into freshly assigned hot slots: one stacked
        copy on the side stream into a fresh device buffer (it overlaps
        the cohorts in flight), then the scatter on the main stream after
        a stream wait, so in-flight cohorts that read the arena keep
        stream order."""
        cuda = self.device.type == "cuda"

        def stack(*ls):
            if not cuda:
                return torch.stack(ls)
            out = torch.empty((len(ls),) + tuple(ls[0].shape),
                              dtype=ls[0].dtype, pin_memory=True)
            return torch.stack(ls, out=out)

        stacked = tree_map(stack, *rows)
        self.h2d_bytes_total += _tree_nbytes(stacked)
        if cuda:
            main = torch.cuda.current_stream(self.device)
            side = self._side_stream()
            with torch.cuda.stream(side):
                dev_rows = tree_map(
                    lambda h: h.to(self.device, non_blocking=True), stacked)
            main.wait_stream(side)
            tree_map(lambda t: t.record_stream(main), dev_rows)
        else:
            dev_rows = stacked
        idx = self._h2d(np.asarray(slots, np.int64))[0]
        put_rows_(self._arena_opt, idx, dev_rows)

    def init_opt_rows(self, params_tree, slots):
        """Re-initialize never-spilled slots' opt rows on the device
        (``opt.init`` is value-independent: bitwise the all-resident
        arena's state for a client that has not trained yet)."""
        self._ensure_state_arenas(params_tree)
        n = len(slots)
        fresh = self.clients[0].opt.init(params_tree)
        rows = tree_map(lambda l: l.unsqueeze(0).expand((n,) + l.shape),
                        fresh)
        idx = self._h2d(np.asarray(slots, np.int64))[0]
        put_rows_(self._arena_opt, idx, rows)

    def prefetch_upcoming(self, heap, pending):
        """Lookahead prefetch for the async loop: peek the next
        ``lookahead`` completions of the event heap (pop k, push back:
        O(k log N)) and stage their members' hot slots.  ``pending``
        filters ghosts (fault duplicates whose plan already delivered)."""
        if self.store is None or not heap:
            return
        k = min(self.store.lookahead, len(heap))
        if k <= 0:
            return
        head = [heapq.heappop(heap) for _ in range(k)]
        for entry in head:
            heapq.heappush(heap, entry)
        self.store.prefetch_cids(
            [cid for _, cid in head if cid in pending])

    def prefetch_plans(self, plans):
        """Lookahead prefetch for the FedAvg barrier: stage the next
        chunk's members (same-round plans only)."""
        if self.store is not None:
            self.store.prefetch_cids([p.cid for p in plans])

    def stats(self) -> dict:
        from repro_torch.kernels.dp_clip import dp_clip
        out = {
            "data_path": "arena" if self.use_arena else "host",
            "dp_path": self.dp_path,
            "pallas_interpret": (
                kernel_info(self.device, dp_clip,
                            dp_clip.launches() - self._launches0)
                if self.dp_path == "pallas" else None),
            "cohorts": self.cohorts_run,
            "h2d_bytes_total": int(self.h2d_bytes_total),
            "h2d_bytes_per_cohort": (
                self.h2d_bytes_total / self.cohorts_run
                if self.cohorts_run else 0.0),
            "pipeline_depth": int(self.cfg.pipeline_depth),
            "host_syncs_at_eval": self.host_syncs_at_eval,
            "host_syncs_between_evals": self.host_syncs_between_evals,
            "blocking_submits": self.blocking_submits,
            "drain_waits": self.drain_waits,
        }
        inj = self.fault_injector
        out.update(inj.stats() if inj is not None else zero_fault_stats())
        scr = zero_screen_stats()
        if self.screening is not None:
            scr.update(self.screening.counters)
        scr["screen_verdict_syncs"] = self.screen_verdict_syncs
        out.update(scr)
        st = zero_store_stats()
        if self.store is not None:
            st.update(self.store.stats())
        out.update(st)
        return out

    # -- dispatch ----------------------------------------------------------
    def dispatch(self, c, global_params, seed: int, server_version: int
                 ) -> LocalRoundPlan:
        """Plan one local round: the reference's host bookkeeping (personal
        overlay, accountant step, clock draw, version pull), O(1) per
        client; training is deferred to the cohort step and the batch
        plan to staging."""
        params0 = global_params
        personal_snapshot = None
        if c.personal_keys:
            if c._personal is None:  # first round: adopt global init
                c._personal = {k: global_params[k] for k in c.personal_keys}
            params0 = dict(global_params)
            params0.update(c._personal)
            personal_snapshot = {k: global_params[k] for k in c.personal_keys}
        if self.store is not None:
            # the client may hold no hot slot yet: the write happens at
            # acquire/prefetch time against the slot it then holds
            self.store.note_dispatch(c.cid, params0)
        elif self.use_arena:
            self._queue_write(c.cid, params0)
        elif c.opt_state is None:
            c.opt_state = c.opt.init(params0)
        steps = steps_per_round(c.n_train, c.batch_size, c.local_epochs)
        if c.use_dp and steps > 0:
            c.accountant.step(c.q, c.dp_cfg.noise_multiplier, steps)
        duration = c.clock.round_duration()
        c.update_count += 1
        c.model_version = server_version
        return LocalRoundPlan(
            cid=c.cid,
            params0=None if self.use_arena else params0,
            opt_state=None if self.use_arena else c.opt_state,
            batch_idx=None, key=int(seed), n_steps=steps, duration=duration,
            epsilon=self._client_epsilon(c, steps) if c.use_dp else 0.0,
            model_version=server_version,
            personal_snapshot=personal_snapshot)

    def _materialize_plans(self, plans):
        """Draw the deferred minibatch permutations of the plans being
        staged, in plan order: each client's RNG advances exactly as the
        eager per-dispatch draws did (a client's next dispatch follows
        the staging of its current plan)."""
        for p in plans:
            if p.batch_idx is None:
                c = self.clients[p.cid]
                p.batch_idx = plan_batches(
                    c.rng, c.n_train, c.batch_size, c.local_epochs)

    def _client_epsilon(self, c, steps: int) -> float:
        """Per-round table lookup on the shared EpsilonSchedule
        (bit-identical to ``c.accountant.epsilon``)."""
        sched = self._eps_sched.get(c.cid)
        if sched is None:
            sched = _accountant.cached_epsilon_schedule(
                c.q, c.dp_cfg.noise_multiplier, steps, self.cfg.delta,
                orders=c.accountant.orders)
            self._eps_sched[c.cid] = sched
        return sched.epsilon_after_rounds(c.update_count)

    # -- cohort step -------------------------------------------------------
    def _pad_idx(self, idx, batch_size: int):
        """Pad one member's (S, B) plan to (s_max, B) with masked tail rows
        (repeat the first row; all-zeros when S == 0)."""
        if idx.shape[0] >= self.s_max:
            return idx
        pad_row = idx[:1] if idx.shape[0] else np.zeros(
            (1, batch_size), np.int32)
        return np.concatenate(
            [idx, np.broadcast_to(
                pad_row, (self.s_max - idx.shape[0],) + pad_row.shape[1:])])

    def run_cohort(self, plans):
        """Stage and submit in one call (the serial driver's entry point;
        the loops call the halves)."""
        return self.submit_cohort(self.stage_cohort(plans))

    def stage_cohort(self, plans) -> StagedCohort:
        """Assemble one cohort's device inputs ahead of submission: draw
        the lazy batch plans, resolve hot slots, flush the queued dispatch
        writes and copy the plans to the device without a host wait."""
        self._materialize_plans(plans)
        self._await_serial()
        k = len(plans)
        if not self.use_arena:
            return self._stage_host(plans, k)
        # slot resolution precedes the flush: the store's acquire queues
        # params writes for faulted-in members, and they ride this flush
        cids = [p.cid for p in plans]
        if self.store is not None:
            member_slots = self.store.acquire_cohort(cids)
        else:
            member_slots = cids
        self._flush_writes()
        # on a mesh the cohort pads to a multiple of the data-axis product
        # with zero-step members on the pad rows
        k_pad = (padded_cohort_size(k, self._n_data, self.cfg.pow2_cohorts)
                 if self._n_data > 1 else k)
        slots = np.full((k_pad,), self.pad_slot, np.int32)
        slots[:k] = member_slots
        dslots = None
        if not self._data_slots_identical:
            dslots = np.full((k_pad,), self.data_arena.pad_slot, np.int32)
            dslots[:k] = self._data_slot_of[cids]
        if self.s_max == 0:  # degenerate: no client has a full batch
            slots_d = self._h2d(slots)[0].long()
            return StagedCohort(plans=plans, k=k, degenerate=True,
                                slots=slots_d, data_slots=slots_d)
        batch_size = self.clients[0].batch_size
        batch_idx = np.zeros((k_pad, self.s_max, batch_size), np.int32)
        for i, p in enumerate(plans):
            batch_idx[i] = self._pad_idx(p.batch_idx, batch_size)
        n_steps = np.zeros((k_pad,), np.int32)
        n_steps[:k] = [p.n_steps for p in plans]
        scales = np.ones((k_pad,), np.float32)  # pad members stay clean
        scales[:k] = [p.corrupt_scale for p in plans]
        self.cohorts_run += 1
        self.h2d_bytes_total += (batch_idx.nbytes + slots.nbytes
                                 + n_steps.nbytes + scales.nbytes
                                 + (dslots.nbytes if dslots is not None
                                    else 0))
        arrays = [slots, batch_idx, n_steps, scales]
        if dslots is not None:
            arrays.append(dslots)
        dev = self._h2d(*arrays)
        slots_d = dev[0].long()
        return StagedCohort(
            plans=plans, k=k, slots=slots_d,
            data_slots=dev[4].long() if dslots is not None else slots_d,
            batch_idx=dev[1].long(), n_steps=n_steps, live_steps=dev[2],
            corrupt=dev[3])

    def _gather_batches(self, plans):
        """The host-fed batches: each member's (s_max, B, ...) rows cut
        from its numpy dataset, stacked to (K, s_max, B, ...) per key.
        Returns (sorted keys, arrays)."""
        member_batches = []
        for p in plans:
            c = self.clients[p.cid]
            idx = self._pad_idx(p.batch_idx, c.batch_size)
            member_batches.append({kk: v[idx] for kk, v in c.data.items()})
        names = sorted(member_batches[0])
        return names, [np.stack([mb[kk] for mb in member_batches])
                       for kk in names]

    def _stage_host(self, plans, k: int) -> StagedCohort:
        """The host-fed path: the stacked batches copied up; the pulled
        params and the clients' optimizer states stacked on the device."""
        if self.s_max == 0:
            return StagedCohort(plans=plans, k=k, degenerate=True,
                                arena=False)
        names, batches_np = self._gather_batches(plans)
        n_steps = np.array([p.n_steps for p in plans], np.int32)
        scales = np.array([p.corrupt_scale for p in plans], np.float32)
        self.cohorts_run += 1
        # the reference's count: the batches plus 4 bytes per member each
        # for the step counts and the noise keys' share
        self.h2d_bytes_total += (sum(a.nbytes for a in batches_np)
                                 + 4 * k + 4 * k)
        dev = self._h2d(*batches_np, n_steps, scales)
        batches = {kk: (t.long() if kk == "y" else t)
                   for kk, t in zip(names, dev)}
        return StagedCohort(
            plans=plans, k=k, arena=False,
            stacked_params=stack_trees([p.params0 for p in plans]),
            stacked_opt=stack_trees([p.opt_state for p in plans]),
            batches=batches, n_steps=n_steps, live_steps=dev[-2],
            corrupt=dev[-1])

    def submit_cohort(self, staged: StagedCohort):
        """Enqueue the cohort step; returns the stacked (K, ...) uploads
        and keeps the screen outputs for :meth:`take_screen_handle`.  The
        serial driver waits for the cohort (a counted ``blocking_submits``
        host sync) when it stages the next one, so the merge is enqueued
        while the step runs; the pipelined one never waits here."""
        plans = staged.plans
        if not staged.degenerate and self._submits_block:
            self.blocking_submits += 1
            self.note_host_sync()
        if staged.degenerate:
            self._last_screen = None
            if not staged.arena:
                return stack_trees([p.params0 for p in plans])
            return take_rows(self._arena_params, staged.slots)
        gens = [torch.Generator(self.device).manual_seed(p.key)
                if self.noise_streams is None else self.noise_streams(p.key)
                for p in plans]
        if staged.n_steps is not None and len(staged.n_steps) > len(plans):
            # a mesh's pad members (zero steps: they draw nothing)
            gens += [torch.Generator(self.device).manual_seed(0)
                     for _ in range(len(staged.n_steps) - len(plans))]
        if not staged.arena:
            upload, new_opt, screen = self.cohort_step(
                staged.stacked_params, staged.stacked_opt, staged.batches,
                gens, staged.n_steps, self._noise_std, staged.corrupt,
                live_steps=staged.live_steps)
            for i, p in enumerate(plans):
                self.clients[p.cid].opt_state = unstack_tree(new_opt, i)
        else:
            upload, self._arena_opt, screen = self.cohort_step(
                self._arena_params, self._arena_opt, self._arena_data,
                staged.slots, staged.data_slots, staged.batch_idx, gens,
                staged.n_steps, self._noise_std, staged.corrupt,
                live_steps=staged.live_steps)
            if self.store is not None:
                # every member's opt row was written (dropped and screened
                # members trained too), so eviction must spill it
                self.store.note_trained([p.cid for p in plans])
        self._last_screen = screen
        self.last_partition = self.cohort_step.partition
        if self._submits_block:
            self._serial_done = self.cohort_done()
        return upload

    def take_screen_handle(self):
        """Return and clear the last cohort's device screen outputs."""
        screen, self._last_screen = self._last_screen, None
        return screen

    def fetch_screen(self, handle, k: int):
        """One device->host fetch of a cohort's (finite, norm) pair,
        counted as ``screen_verdict_syncs``.  A degenerate cohort never
        trained: every member is finite with a zero-delta norm."""
        if handle is None:
            return np.ones((k,), bool), np.zeros((k,), np.float32)
        self._in_screen = True
        try:
            fin, nrm = _host_fetch_array(self, handle)
        finally:
            self._in_screen = False
        return fin.numpy()[:k], nrm.numpy()[:k]

    def upload(self, plan: LocalRoundPlan, new_params):
        """A member's trained params as uploaded: personal subtrees stay on
        the client, the upload carries the received globals there."""
        c = self.clients[plan.cid]
        if not c.personal_keys:
            return new_params
        c._personal = {k: new_params[k] for k in c.personal_keys}
        up = dict(new_params)
        up.update(plan.personal_snapshot)
        return up


def _coeffs_f32(runner, coeffs):
    """Merge coefficients rounded to the merge dtype (float32) on the host
    (reference engine.py:905), then one staged upload."""
    return runner._h2d(np.asarray(coeffs, dtype=np.float32))[0]


def _members(stacked, k: int):
    """The cohort's ``k`` real members of a (on a mesh, padded) stack.  The
    reference merges the padded stack with zero coefficients; the port
    drops the pad rows instead, so the merge is the one-process merge bit
    for bit (a product over K_pad rows may round differently on the card,
    pad zeros or not)."""
    return tree_map(lambda l: l[:k], stacked)


def _fused_ok(strategy, clients, plans, cfg: EngineConfig) -> bool:
    """The weights-vector merge is exact only for plain FedAvg and
    FedAsync; FedBuff keeps buffer state across cohorts, AdaptiveAsync
    reads each member's epsilon, the robust strategies are not weighted
    sums, and personalized clients upload overlaid trees."""
    if not cfg.fused_merge:
        return False
    if type(strategy) not in (FedAvg, FedAsync):
        return False
    return not any(clients[p.cid].personal_keys for p in plans)


def _oracles(runner, clients, faults, screening):
    injector = (FaultInjector(faults, len(clients))
                if faults is not None else None)
    screener = (ScreeningState(screening, len(clients))
                if screening is not None else None)
    runner.fault_injector = injector
    runner.screening = screener
    return injector, screener


def run_fedavg_engine(
    clients: list,
    global_params,
    accuracy_fn: Callable,
    test_data: dict,
    rounds: int = 60,
    seed: int = 0,
    eval_every: int = 1,
    target_acc: Optional[float] = None,
    engine_cfg: Optional[EngineConfig] = None,
    mesh=None,
    runner: Optional[CohortRunner] = None,
    faults=None,
    checkpoint=None,
    resume_from: Optional[str] = None,
    strategy=None,
    screening=None,
    data_arena=None,
) -> tuple:
    """Synchronous FedAvg (Eq. 9): each round is one full-population
    barrier, run as ceil(N / max_cohort) cohort chunks whose dataset-size
    weighted partial sums accumulate into the new globals.

    ``faults``: lost members keep their cohort slot with weight 0, the
    barrier honours ``round_deadline_s``/``min_quorum`` with survivor-
    renormalized weights, and churn stretches a member's round.
    ``strategy`` picks the aggregator (robust ones go through
    ``aggregate``); ``screening`` rejects delivered uploads from the
    step's verdict outputs.  ``checkpoint`` (a
    :class:`repro_torch.engine.resilience.CheckpointPolicy`) snapshots
    the run every ``checkpoint.every`` rounds; ``resume_from`` (a
    checkpoint directory) resumes an aborted run bit-identically.
    ``runner`` injects a prebuilt, reset runner (the Session's); its
    config and data arena win over ``engine_cfg`` and ``data_arena`` (a
    :class:`DataArena`; built from the clients when None)."""
    cfg = _resolve_cfg(engine_cfg if runner is None else runner.cfg, mesh)
    if runner is None:
        runner = CohortRunner(clients, cfg,
                              tree_leaves(global_params)[0].device,
                              data_arena=data_arena)
    if strategy is None:
        strategy = FedAvg()
    if strategy.is_async:
        raise ValueError(
            f"run_fedavg_engine requires a synchronous strategy, got "
            f"{strategy.name!r} — use run_async_engine")
    injector, screener = _oracles(runner, clients, faults, screening)
    log = RunLog(strategy=strategy.name)
    rng = np.random.default_rng(seed)
    t_virtual = 0.0
    for c in clients:
        log.update_counts[c.tier] = 0
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    start_rnd = 1
    if resume_from is not None:
        from repro_torch.engine import resilience as _rez
        global_params, t_virtual, rnd0 = _rez.restore_fedavg(
            resume_from, runner, clients, log, injector, global_params, rng)
        start_rnd = rnd0 + 1
        if checkpoint is not None:
            checkpoint.mark(rnd0)

    # pipelined across rounds: round r+1 trains from round r's merged
    # globals, a device result its dispatch writes reference, so up to
    # pipeline_depth rounds stay in flight between evals
    inflight = deque()
    for rnd in range(start_rnd, rounds + 1):
        seeds = rng.integers(0, SEED_HIGH, size=len(clients))
        plans = []
        for c, s in zip(clients, seeds):
            p = runner.dispatch(c, global_params, s, rnd - 1)
            if injector is not None and rnd > 1:
                # leave/rejoin churn stretches the member's barrier round
                p.duration += injector.redispatch_delay(c.cid, t_virtual)
            plans.append(p)
        t_round0 = t_virtual
        t_deliver = [t_round0 + p.duration for p in plans]
        if injector is not None:
            # fates resolve before the step so each delivered member's
            # corruption scale rides into the step's runtime scale vector
            offsets = [injector.fedavg_fate(p.cid, t_virtual, p.duration)[0]
                       for p in plans]
            keep, round_time = apply_deadline(injector.model, offsets)
            for i, (p, off, kept) in enumerate(zip(plans, offsets, keep)):
                p.dropped = not kept
                t_deliver[i] = None if off is None else t_round0 + off
                if off is not None:
                    p.corrupt_scale = injector.take_corruption(p.cid)
                    if not kept:
                        injector.note_deadline_drop(p.cid, t_round0 + off)
            if any(p.dropped for p in plans):
                injector.note_degraded()
            t_virtual += (round_time if round_time is not None
                          else max(p.duration for p in plans))
        else:
            t_virtual += max(p.duration for p in plans)
        chunks = [plans[i:i + cfg.max_cohort]
                  for i in range(0, len(plans), cfg.max_cohort)]
        stacked_chunks, screen_handles = [], []
        for ci, ch in enumerate(chunks):
            stacked_chunks.append(
                runner.submit_cohort(runner.stage_cohort(ch)))
            screen_handles.append(runner.take_screen_handle())
            if ci + 1 < len(chunks):
                # the store stages the next chunk's hot slots while this
                # chunk's step runs (same-round plans only)
                runner.prefetch_plans(chunks[ci + 1])
        log.cohort_sizes.extend(len(ch) for ch in chunks)
        if screener is not None:
            i0 = 0
            for ch, handle in zip(chunks, screen_handles):
                fin, nrm = runner.fetch_screen(handle, len(ch))
                for j, p in enumerate(ch):
                    if not p.dropped and not screener.screen(
                            p.cid, t_deliver[i0 + j], fin[j], nrm[j]):
                        p.dropped = True
                i0 += len(ch)

        if _fused_ok(strategy, clients, plans, cfg):
            # Eq. 9 over the surviving members; a dropped member keeps its
            # slot with coefficient exactly 0
            if any(not p.dropped for p in plans):
                _, kept_coeffs = fedavg_weights(
                    [clients[p.cid].n_train for p in plans if not p.dropped])
                it = iter(kept_coeffs)
                coeffs = [0.0 if p.dropped else next(it) for p in plans]
                merged = tree_map(torch.zeros_like, global_params)
                off = 0
                for ch, st in zip(chunks, stacked_chunks):
                    merged = runner.merge_cohort(
                        merged, _members(st, len(ch)),
                        _coeffs_f32(runner, coeffs[off:off + len(ch)]), 1.0)
                    off += len(ch)
                global_params = merged
        else:
            updates = []
            for ch, st in zip(chunks, stacked_chunks):
                updates.extend(
                    (runner.upload(p, unstack_tree(st, i)),
                     clients[p.cid].n_train)
                    for i, p in enumerate(ch) if not p.dropped)
            if updates:
                global_params = strategy.aggregate(global_params, updates)

        for p in plans:
            if p.dropped:
                continue
            c = clients[p.cid]
            log.update_counts[c.tier] += 1
            log.staleness[c.tier].append(0)  # barrier => no staleness
            log.eps_trajectory[c.tier].append(p.epsilon)

        if rnd % eval_every == 0 or rnd == rounds:
            runner.eval_boundary(True)
            acc = _host_fetch(runner, accuracy_fn(global_params, test_data))
            log.times.append(t_virtual)
            log.global_acc.append(acc)
            log.server_version.append(rnd)
            eval_all(clients, global_params, accuracy_fn, log)
            runner.eval_boundary(False)
            inflight.clear()
            if target_acc is not None and acc >= target_acc:
                break
        elif runner.pipelined:
            inflight.append(runner.cohort_done())
            runner.drain(inflight)

        if checkpoint is not None and rnd < rounds and checkpoint.due(rnd):
            from repro_torch.engine import resilience as _rez
            _rez.save_fedavg(checkpoint, runner, clients, log, injector,
                             global_params, rng, t_virtual, rnd)

    finish_log(log, clients, injector, screener)
    log.engine_stats = validate_engine_stats(runner.stats())
    return global_params, log


def run_async_engine(
    clients: list,
    global_params,
    accuracy_fn: Callable,
    test_data: dict,
    strategy,                      # FedAsync / FedBuff / AdaptiveAsync
    max_updates: int = 300,
    max_time: Optional[float] = None,
    seed: int = 0,
    eval_every: int = 5,
    target_acc: Optional[float] = None,
    engine_cfg: Optional[EngineConfig] = None,
    mesh=None,
    runner: Optional[CohortRunner] = None,
    faults=None,
    checkpoint=None,
    resume_from: Optional[str] = None,
    screening=None,
    data_arena=None,
) -> tuple:
    """Event-driven async FL (Eq. 10-11) over cohorts popped from the
    virtual-clock heap.  ``staleness_window=0`` reproduces the legacy loop
    update-for-update; a positive window batches near-simultaneous
    completions into one cohort step.

    ``faults``: every popped completion is a delivery attempt the
    injector resolves (duplicates deduped, retried/late uploads re-enter
    the heap, lost updates stay in the cohort with weight 0).
    ``screening`` turns rejected and quarantined deliveries into
    zero-weight members too.  ``checkpoint`` snapshots the run (server
    params, arenas, the store, RNG streams, the event heap) every
    ``checkpoint.every`` merged updates; ``resume_from`` resumes an
    aborted run bit-identically (FedBuff refuses both: its buffer holds
    live device trees)."""
    cfg = _resolve_cfg(engine_cfg if runner is None else runner.cfg, mesh)
    if runner is None:
        runner = CohortRunner(clients, cfg,
                              tree_leaves(global_params)[0].device,
                              data_arena=data_arena)
    if not strategy.is_async:
        raise ValueError(
            f"run_async_engine requires an asynchronous strategy, got "
            f"{strategy.name!r} — use run_fedavg_engine")
    if ((checkpoint is not None or resume_from is not None)
            and isinstance(strategy, FedBuff)):
        raise ValueError(
            "checkpoint/resume does not support FedBuff — its cross-cohort "
            "buffer holds live device trees the snapshot cannot capture")
    injector, screener = _oracles(runner, clients, faults, screening)
    log = RunLog(strategy=strategy.name)
    rng = np.random.default_rng(seed)
    for c in clients:
        log.update_counts[c.tier] = 0
        log.influence.setdefault(c.tier, 0.0)
        log.staleness.setdefault(c.tier, [])
        log.eps_trajectory.setdefault(c.tier, [])

    # every client starts training version 0 at t=0
    heap, pending = [], {}
    server_version = 0
    t_virtual = 0.0
    if resume_from is not None:
        from repro_torch.engine import resilience as _rez
        global_params, t_virtual, server_version = _rez.restore_async(
            resume_from, runner, clients, log, injector, global_params,
            heap, pending, rng)
        if checkpoint is not None:
            checkpoint.mark(sum(log.update_counts.values()))
    else:
        # O(1)-per-client dispatches (the batch permutations draw lazily
        # at staging) and one heapify, pop-order identical to N pushes
        seeds = rng.integers(0, SEED_HIGH, size=len(clients))
        for c, s in zip(clients, seeds):
            plan = runner.dispatch(c, global_params, s, server_version)
            pending[c.cid] = plan
            heap.append((plan.duration, c.cid))
        heapq.heapify(heap)
        # the store warms the hot set for the first cohorts (a restore
        # skips this: the snapshot already reflects it)
        runner.prefetch_upcoming(heap, pending)

    done = False
    inflight = deque()
    while heap and not done:
        events = pop_cohort(heap, cfg.staleness_window, cfg.max_cohort,
                            bucket_pow2=cfg.pow2_cohorts)
        plans = []
        if injector is None:
            for t, cid in events:
                p = pending.pop(cid)
                p.t_complete = t
                plans.append(p)
        else:
            for t, cid in events:
                verdict, aux = injector.on_completion(cid, t)
                if verdict == "duplicate":
                    continue
                if verdict == "requeue":
                    heapq.heappush(heap, (aux, cid))
                    continue
                p = pending.pop(cid)
                p.t_complete = t
                if verdict == "drop":
                    p.dropped = True
                else:
                    p.corrupt_scale = injector.take_corruption(cid)
                    if aux is not None:     # deliver + a scheduled dup copy
                        heapq.heappush(heap, (aux, cid))
                plans.append(p)
            if not plans:                   # the whole pop was ghosts/retries
                continue
        t_virtual = plans[-1].t_complete
        new_stacked = runner.submit_cohort(runner.stage_cohort(plans))
        screen_handle = runner.take_screen_handle()
        log.cohort_sizes.append(len(plans))
        n_dropped = sum(1 for p in plans if p.dropped)
        if n_dropped:
            injector.note_degraded()
        if screener is not None:
            fin, nrm = runner.fetch_screen(screen_handle, len(plans))
            for j, p in enumerate(plans):
                if not p.dropped and not screener.screen(
                        p.cid, p.t_complete, fin[j], nrm[j]):
                    p.dropped = True
            n_dropped = sum(1 for p in plans if p.dropped)

        taus, weights = [], []
        if _fused_ok(strategy, clients, plans, cfg):
            # staleness weights alpha/(1+tau_i) folded into one reduction;
            # member i's tau counts the earlier delivered merges of this
            # cohort, a dropped member merges with coefficient exactly 0
            n_del = 0
            for p in plans:
                if p.dropped:
                    taus.append(0)
                    weights.append(0.0)
                else:
                    tau = (server_version + n_del) - p.model_version
                    taus.append(tau)
                    weights.append(strategy.mixing_weight(tau))
                    n_del += 1
            g_coeff, coeffs = fold_cohort_weights(weights)
            global_params = runner.merge_cohort(
                global_params, _members(new_stacked, len(plans)),
                _coeffs_f32(runner, coeffs), g_coeff)
            server_version += n_del
        else:
            # member by member, in the cohort's order
            for i, p in enumerate(plans):
                if p.dropped:
                    taus.append(0)
                    weights.append(0.0)
                    continue
                up = runner.upload(p, unstack_tree(new_stacked, i))
                tau = server_version - p.model_version
                global_params, inc, w = apply_update(
                    strategy, global_params, up, tau, eps_spent=p.epsilon)
                server_version += inc
                taus.append(tau)
                weights.append(w)

        for p, tau, w in zip(plans, taus, weights):
            if p.dropped:
                continue
            c = clients[p.cid]
            log.staleness[c.tier].append(tau)
            log.update_counts[c.tier] += 1
            log.eps_trajectory[c.tier].append(p.epsilon)
            log.influence[c.tier] += float(w)

        total_updates = sum(log.update_counts.values())
        crossed = any((total_updates - j) % eval_every == 0
                      for j in range(len(plans) - n_dropped))
        if crossed:
            runner.eval_boundary(True)
            acc = _host_fetch(runner, accuracy_fn(global_params, test_data))
            log.times.append(t_virtual)
            log.global_acc.append(acc)
            log.server_version.append(server_version)
            eval_all(clients, global_params, accuracy_fn, log)
            runner.eval_boundary(False)
            inflight.clear()
            if target_acc is not None and acc >= target_acc:
                done = True
        if total_updates >= max_updates or (max_time and t_virtual >= max_time):
            done = True

        if not done:
            for p in plans:
                c = clients[p.cid]
                # a client that exhausted its privacy budget stops training
                # (dropped members re-dispatch: their budget was spent)
                if (isinstance(strategy, AdaptiveAsync)
                        and p.epsilon >= strategy.eps_target):
                    continue
                plan = runner.dispatch(c, global_params,
                                       rng.integers(0, SEED_HIGH),
                                       server_version)
                pending[c.cid] = plan
                t_next = p.t_complete + plan.duration
                if injector is not None:
                    t_next += injector.redispatch_delay(c.cid, p.t_complete)
                heapq.heappush(heap, (t_next, c.cid))
            # the store stages the heap head's members while the submitted
            # cohort runs
            runner.prefetch_upcoming(heap, pending)
            if runner.pipelined:
                inflight.append(runner.cohort_done())
                runner.drain(inflight)
            if checkpoint is not None and checkpoint.due(total_updates):
                from repro_torch.engine import resilience as _rez
                _rez.save_async(checkpoint, runner, clients, log, injector,
                                global_params, rng, heap, pending, t_virtual,
                                server_version, total_updates)

    finish_log(log, clients, injector, screener)
    log.engine_stats = validate_engine_stats(runner.stats())
    return global_params, log
