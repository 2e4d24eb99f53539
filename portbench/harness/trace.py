"""The traced window: device activity from ``torch.profiler`` (CUDA only,
over the window's first units of work, see TRACE_SECONDS) and the host
phases the drivers mark, and the
arithmetic that reduces them: the union of device intervals, the device
time by kernel name, and the idle gaps labelled by the host phase that
was running.

The union and the idle share are frozen copies of the arithmetic of
``chip_smoke.py::_window_idle_share`` (the union of the device
activities' intervals over a window), applied here to a cell's traced
window.  Only device activity is recorded: the host ops' events took the
profiler some 35 s to gather per window there.  The host side is the
drivers' own phase marks (a perf_counter_ns pair per phase), aligned to
the device clock by a marker kernel launched right after a synchronise.
"""
from __future__ import annotations

import contextlib
import time


def union_busy(intervals) -> float:
    """Total length covered by the union of ``(start, end)`` intervals."""
    busy, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    return busy


def gaps(intervals, lo, hi) -> list:
    """The idle ``(start, end)`` gaps of ``[lo, hi]`` outside the union."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def time_by_name(kernels) -> dict:
    """Device seconds per kernel name (ns intervals in)."""
    out = {}
    for name, a, b in kernels:
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def label_gap(gap, phases) -> str:
    """The host phase that overlaps ``gap`` most (the innermost, shortest,
    on a tie), or ``"host: unmarked"``."""
    best, best_len, best_span = "host: unmarked", 0, None
    a, b = gap
    for name, pa, pb in phases:
        ov = min(b, pb) - max(a, pa)
        span = pb - pa
        if ov > best_len or (ov == best_len and ov > 0
                             and span < best_span):
            best, best_len, best_span = name, ov, span
    return best


# seconds of the window the profiler records: reading its results costs
# some 26 us per device activity (the FL cell launches ~1e5 a second), so
# a traced run records the window's first units of work that end past
# this, and runs the rest of its window untraced
TRACE_SECONDS = 8.0


class Tracer:
    """Host phase marks always (a list append per phase); with ``on``, the
    profiler over the window's first units of work: started by
    :meth:`start` after a synchronise, stopped by the first :meth:`tick`
    (a driver's mark that a unit of work was sent) past ``seconds``, after
    a synchronise, or at :meth:`stop`."""

    def __init__(self, on: bool, device: str = "cuda",
                 seconds: float = TRACE_SECONDS):
        self.on = on
        self.device = device
        self.seconds = seconds
        self.units = 0                # units of work sent
        self.traced_units = None      # units inside the traced window
        self.phases = []              # (name, t0_ns, t1_ns), host clock
        self.kernels = []             # (name, start_ns, end_ns), device clock
        self._prof = None
        self.offset_ns = 0            # device clock - host clock
        self.t0_ns = self.t1_ns = self.trace_end_ns = None

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.phases.append((name, t0, time.perf_counter_ns()))

    def sync(self):
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()

    def start(self):
        import torch
        self.sync()
        if self.on:
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
            self._mark_ns = time.perf_counter_ns()
            self._marker = torch.ones(1, device="cuda").mul_(3.0)
        self.t0_ns = time.perf_counter_ns()

    def tick(self):
        """One more unit of work sent; ends the traced window once it has
        lasted ``seconds``."""
        self.units += 1
        if (self._prof is not None and self.trace_end_ns is None
                and time.perf_counter_ns() - self.t0_ns
                >= self.seconds * 1e9):
            self._end_trace()

    def _end_trace(self):
        self.sync()
        self.trace_end_ns = time.perf_counter_ns()
        self.traced_units = self.units
        self._prof.stop()

    def stop(self):
        self.sync()
        self.t1_ns = time.perf_counter_ns()
        if self._prof is not None and self.trace_end_ns is None:
            self._end_trace()

    @property
    def window_s(self) -> float:
        """The run's whole window."""
        return (self.t1_ns - self.t0_ns) * 1e-9

    @property
    def trace_window_s(self) -> float:
        return (self.trace_end_ns - self.t0_ns) * 1e-9

    def collect(self):
        """Read the device activities out of the stopped profiler."""
        if self._prof is None:
            return
        self.kernels = device_events(self._prof)
        if not self.kernels:
            raise RuntimeError("the profiler recorded no device activity")
        # the first activity is the marker, launched right after _mark_ns
        self.offset_ns = self.kernels[0][1] - self._mark_ns
        self._prof = None

    # -- reductions --------------------------------------------------------
    def device_window(self):
        return (self.t0_ns + self.offset_ns,
                self.trace_end_ns + self.offset_ns)

    def busy_s(self) -> float:
        lo, hi = self.device_window()
        return union_busy([(max(a, lo), min(b, hi))
                           for _, a, b in self.kernels
                           if b > lo and a < hi]) * 1e-9

    def kernel_seconds(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum((b - a) for n, a, b in self.kernels if match(n)) * 1e-9

    def breakdown(self, top: int = 10) -> dict:
        by_name = sorted(time_by_name(self.kernels).items(),
                         key=lambda kv: -kv[1])[:top]
        lo, hi = self.device_window()
        idle = gaps([(a, b) for _, a, b in self.kernels], lo, hi)
        idle.sort(key=lambda g: g[0] - g[1])
        phases = [(n, a + self.offset_ns, b + self.offset_ns)
                  for n, a, b in self.phases]
        named = [[label_gap(g, phases), (g[1] - g[0]) * 1e-9]
                 for g in idle[:top]]
        return {"device_ops": [[n, s] for n, s in by_name],
                "idle_gaps": named}


def device_events(prof) -> list:
    """``(name, start_ns, end_ns)`` of every device activity (kernels,
    copies, sets) in the profiler's results, sorted by start.  Reads the
    kineto results directly: building the FunctionEvent tree for some
    10^5 events takes far longer."""
    out = []
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        for e in results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            if hasattr(e, "start_ns"):
                a = e.start_ns()
                b = a + e.duration_ns()
            else:
                a = e.start_us() * 1000
                b = a + e.duration_us() * 1000
            out.append((e.name(), int(a), int(b)))
    else:
        for e in prof.events():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            out.append((e.name, int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
    out.sort(key=lambda t: t[1])
    return out
