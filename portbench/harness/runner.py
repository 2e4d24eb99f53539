"""One run of one cell: set-up, the measured window, the reading of the
trace, the freeing of the program's state and the reference check, in
that order, and the result line.

A driver (``portbench/drivers/<kind>.py``) gives these functions:

    setup(cell, seed, device) -> state       build and warm the system
    window(state, seconds, tracer) -> Work   drive it for ``seconds``
    release(state) -> outputs               free the program's state,
                                            keeping what the check reads
    readings(outputs, cell, seed, device) -> {name: value}
                                            every number the check reads,
                                            against the cell's reference
    control(outputs, cell, seed, device) -> {name: value}
                                            the same numbers of the
                                            lower-precision control (not
                                            run by the benchmark's runs)

The check compares the readings named in the cell's limits file
(``portbench/limits/<cell>.json``): a number passes when it is at most
its limit, and one the driver did not read fails.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

from portbench.harness.trace import Tracer

GIB = float(1 << 30)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Work:
    """What a window did: ``rate_metric`` over ``units`` of work, the
    attempts and failures, and the counts the per-layer readers use."""

    rate_metric: str
    units: float
    attempted: int
    failed: int
    counters: dict = field(default_factory=dict)


@dataclass
class Reading:
    """What a per-layer metric's reader gets: the traced window's length,
    the units of work inside it (``units``: the first ones of the run's)
    and the driver's counters, whose per-unit lists the readers cut to
    those units."""

    work: Work
    tracer: Tracer
    window_s: float
    units: int

    @property
    def counters(self) -> dict:
        return self.work.counters


def device_info(count: int, peak_bytes: int, device: str) -> dict:
    import torch
    if device == "cpu":         # the CPU tests' runs: no device numbers
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def compare(got: dict, limits: dict) -> dict:
    """Each limited number beside its limit; one not read is infinite."""
    out = {}
    for name, lim in limits.items():
        v = float(got.get(name, float("inf")))
        out[name] = {"value": v, "limit": float(lim), "ok": bool(v <= lim)}
    return out


def run_cell(bench, cell, *, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", extra: bool = False,
             control: bool = False) -> dict:
    """One run of ``cell``; with ``extra`` the result also holds every
    reading (``readings``, compared or not) and with ``control`` the
    control's readings on the same outputs (``control``)."""
    import torch
    driver = bench.driver(cell.kind)
    state = driver.setup(cell, seed, device)
    tracer = Tracer(trace, device)
    tracer.sync()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    tracer.start()
    setup_s = time.perf_counter() - t_start
    work = driver.window(state, seconds, tracer)
    tracer.stop()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    window_s = tracer.window_s
    outputs = driver.release(state)
    del state
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    tracer.collect()
    log(f"setup_s {setup_s:.3f}, window_s {window_s:.3f}, units "
        f"{work.units}, peak {peak / GIB:.3f} GiB; trace read in "
        f"{time.perf_counter() - t:.1f} s ({len(tracer.kernels)} device "
        f"activities)")

    result = {"correct": None, "attempted": work.attempted,
              "failed": work.failed, "metrics": {}, "device": {}}
    if trace:
        reading = Reading(work, tracer, tracer.trace_window_s,
                          tracer.traced_units)
        for m in bench.per_layer(cell):
            value = bench.metric(m["name"]).read(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = tracer.breakdown()
    else:
        e2e = {m["name"]: m for m in bench.end_to_end(cell)}
        values = {work.rate_metric: work.units / window_s,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for name, m in e2e.items():
            result["metrics"][name] = {"value": values[name],
                                       "unit": m["unit"]}
    result["device"] = device_info(cell.chips, peak, device)
    if trace:
        result["device"]["busy_s"] = tracer.busy_s()
        result["device"]["window_s"] = tracer.trace_window_s
    t = time.perf_counter()
    got = driver.readings(outputs, cell, seed, device)
    log(f"check took {time.perf_counter() - t:.1f} s")
    log("read, not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in got.items() if k not in cell.limits))
    if extra:
        result["readings"] = {k: float(v) for k, v in got.items()}
    if control:
        result["control"] = {k: float(v) for k, v in
                             driver.control(outputs, cell, seed,
                                            device).items()}
    # the compared numbers come last in the line
    result["compared"] = compare(got, cell.limits)
    result["correct"] = bool(cell.limits) and all(
        c["ok"] for c in result["compared"].values())
    return result
