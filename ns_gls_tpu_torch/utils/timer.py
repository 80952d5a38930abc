"""Hierarchical wall-time accounting (observability layer).

Equivalent of the reference's scope-timer stack (``timer.h``:
MyTimerOutput/MyScope/ScopedName/TimerCollection): RAII scopes build
``parent::child`` labels from a path stack, a registry accumulates
min/max/avg wall times, and a table is printed at the end of a run.
Device work inside a top-level scope is synchronized on exit
(``torch.cuda.synchronize``) so times are honest.  For kernel-level
traces, wrap runs in ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class TimerCollection:
    """Global registry of path-labelled wall-time accumulators
    (``timer.h:194-253``)."""

    def __init__(self):
        import os

        self._data = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
        self._path = threading.local()
        self.sync = True
        # fence depth: default "top" fences only top-level scopes (the
        # "loop" scope that seconds per step read), so nested attribution
        # adds no synchronization; NS_TIMER_FENCE=all fences every scope,
        # =off none
        mode = os.environ.get("NS_TIMER_FENCE", "top")
        self.fence_depth = (
            10**9 if mode == "all" else 0 if mode == "off" else 1
        )

    @staticmethod
    def _fence():
        """Device completion barrier: wait for the work queued on the
        current CUDA device (a no-op without a card)."""
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def _stack(self):
        if not hasattr(self._path, "stack"):
            self._path.stack = []
        return self._path.stack

    @contextlib.contextmanager
    def scope(self, name: str):
        stack = self._stack()
        stack.append(name)
        label = "::".join(stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and len(stack) <= self.fence_depth:
                self._fence()
            dt = time.perf_counter() - t0
            rec = self._data[label]
            rec[0] += 1
            rec[1] += dt
            rec[2] = min(rec[2], dt)
            rec[3] = max(rec[3], dt)
            stack.pop()

    def reset(self):
        self._data.clear()

    def table(self) -> str:
        if not self._data:
            return "(no timers recorded)"
        w = max(len(k) for k in self._data) + 2
        lines = [
            f"{'scope'.ljust(w)} {'n':>6} {'total[s]':>10} {'avg[s]':>10}"
            f" {'min[s]':>10} {'max[s]':>10}"
        ]
        for k in sorted(self._data):
            n, tot, mn, mx = self._data[k]
            lines.append(
                f"{k.ljust(w)} {n:>6} {tot:>10.4f} {tot / n:>10.4f}"
                f" {mn:>10.4f} {mx:>10.4f}"
            )
        return "\n".join(lines)

    def print_all(self):
        print(self.table(), flush=True)


_collection = TimerCollection()


def timer(name: str):
    """``with timer("a"): ... with timer("b")`` records scope ``a::b``."""
    return _collection.scope(name)


def get_collection() -> TimerCollection:
    return _collection


def time_cuda(fn, n, warmup=0):
    """Milliseconds per call of ``fn`` on the card: n calls between two
    CUDA events, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


# Seconds the profiler windows of ``device_time_us`` and
# ``device_kernels_us`` stay open on each side of the calls.  The profiler
# keeps only the kernels whose device timestamps fall inside its window,
# and the device clock it converts them by drifts from the host's as the
# process ages (milliseconds after minutes:
# ``tools/profiler_clock_drift.py``).
PROFILER_EDGE_S = 0.05


def device_time_us(fn, name: str, n: int = 50, per_call: int = 1) -> float:
    """Mean device time in microseconds of the CUDA kernels whose name
    holds ``name``, of which ``fn`` launches ``per_call``, over n calls
    of ``fn`` under ``torch.profiler`` (the kernel's own time, without
    the host's launch gaps that CUDA events around back-to-back launches
    also count).  The window stays open ``PROFILER_EDGE_S`` on each side
    of the calls.  The mean is over the kernels the profiler recorded,
    which may miss some of them (late in a long process on the H100 it
    has missed whole windows); a window in which it recorded none is
    profiled again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_EDGE_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_EDGE_S)
        rows = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in rows)
        if count:
            break
    if not 0 < count <= n * per_call:
        raise RuntimeError(f"profiled {count} {name} kernels in {n} calls")
    return sum(e.self_device_time_total for e in rows) / count


def device_kernels_us(fn, n: int = 50):
    """(mean device time in microseconds of all the CUDA kernels one call
    of ``fn`` launches, kernels launched per call), over n calls under
    ``torch.profiler``, whose window stays open ``PROFILER_EDGE_S`` on
    each side of the calls.  The profiler may miss a kernel of a window
    (on the H100 it kept 99 of 100 in three windows in a row): each
    kernel's launches a call are its recorded count over n rounded to
    the nearest whole number, and its time its recorded mean."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_EDGE_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_EDGE_S)
    us = launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            k = round(e.count / n)
            us += k * e.self_device_time_total / e.count
            launches += k
    return us, launches


def print_wall_time_statistics():
    _collection.print_all()
