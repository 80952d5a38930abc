"""Hierarchical wall-time accounting and counters (observability layer).

Equivalent of the reference's scope-timer stack (``timer.h``:
MyTimerOutput/MyScope/ScopedName/TimerCollection): RAII scopes build
``parent::child`` labels from a path stack, a registry accumulates
min/max/avg wall times, and a table is printed at the end of a run.  The
same registry holds named counters (``count``): host syncs, operator
applies, V-cycles, rebuilds and kernel launches.

Device work inside a top-level scope is synchronized on exit
(``torch.cuda.synchronize``), so a top-level scope's seconds include
its device work.  A nested scope's seconds are host seconds (the time to
enqueue its work): its device time comes from a ``torch.profiler``
trace.  While a profiler is recording, every scope also opens
``record_function("ns." + label)``, so the program's spans sit in the
trace on the device operations' clock, nested as their labels are
(``benchmark/harness/program.py`` reads them); with no profiler a scope
is two ``perf_counter`` calls and a dict update.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from torch.autograd import profiler as _profiler

# prefix of the profiler ranges of the scopes
RANGE_PREFIX = "ns."


class TimerCollection:
    """Global registry of path-labelled wall-time accumulators
    (``timer.h:194-253``) and of named counters."""

    def __init__(self):
        self._data = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
        self._counts = defaultdict(int)
        self._path = threading.local()

    def _fence(self):
        """Device completion barrier: wait for the work queued on the
        current CUDA device, counted as a ``host_sync`` (a no-op without
        a card)."""
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._counts["host_sync"] += 1
            torch.cuda.synchronize()

    def _stack(self):
        try:
            return self._path.stack
        except AttributeError:
            self._path.stack = []
            return self._path.stack

    def scope(self, name: str) -> "_Scope":
        return _Scope(self, name)

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the counter ``name`` (``n`` = 0 registers it)."""
        self._counts[name] += n

    def counters(self) -> dict:
        """A snapshot of every counter: {name: count}."""
        return dict(self._counts)

    def counters_since(self, before: dict) -> dict:
        """Every counter's change since the snapshot ``before``."""
        return {k: v - before.get(k, 0) for k, v in self._counts.items()}

    def reset(self):
        """Forget the timers and set every counter to zero."""
        self._data.clear()
        for k in self._counts:
            self._counts[k] = 0

    def table(self) -> str:
        lines = []
        if self._data:
            w = max(len(k) for k in self._data) + 2
            lines.append(
                f"{'scope'.ljust(w)} {'n':>6} {'total[s]':>10} {'avg[s]':>10}"
                f" {'min[s]':>10} {'max[s]':>10}"
            )
            for k in sorted(self._data):
                n, tot, mn, mx = self._data[k]
                lines.append(
                    f"{k.ljust(w)} {n:>6} {tot:>10.4f} {tot / n:>10.4f}"
                    f" {mn:>10.4f} {mx:>10.4f}"
                )
        else:
            lines.append("(no timers recorded)")
        counts = {k: v for k, v in self._counts.items() if v}
        if counts:
            w = max(len(k) for k in counts) + 2
            lines.append(f"{'counter'.ljust(w)} {'count':>10}")
            lines.extend(f"{k.ljust(w)} {counts[k]:>10}"
                         for k in sorted(counts))
        return "\n".join(lines)


class _Scope:
    """One scope of a :class:`TimerCollection` (a context manager)."""

    __slots__ = ("coll", "name", "stack", "label", "rf", "t0")

    def __init__(self, coll: TimerCollection, name: str):
        self.coll = coll
        self.name = name

    def __enter__(self):
        self.stack = stack = self.coll._stack()
        stack.append(self.name)
        self.label = "::".join(stack)
        # read at every entry: a profiler may start or stop at any time
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(RANGE_PREFIX + self.label)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        stack = self.stack
        try:
            if len(stack) == 1:
                self.coll._fence()
            dt = time.perf_counter() - self.t0
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            rec = self.coll._data[self.label]
            rec[0] += 1
            rec[1] += dt
            if dt < rec[2]:
                rec[2] = dt
            if dt > rec[3]:
                rec[3] = dt
        finally:
            stack.pop()
        return False


_collection = TimerCollection()


def timer(name: str):
    """``with timer("a"): ... with timer("b")`` records scope ``a::b``."""
    return _collection.scope(name)


# the global registry's counters
count = _collection.count
counters = _collection.counters
counters_since = _collection.counters_since


def host_sync(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, counted as one ``host_sync``: a read of a
    device tensor on the host (``float``, ``bool``, ``Tensor.tolist``,
    ``Tensor.cpu``), or a copy of host values to the device, for which
    the host waits for the stream."""
    _collection._counts["host_sync"] += 1
    return fn(*args, **kwargs)


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
        if (e.device_type == DeviceType.CUDA and e.count
                and not e.is_user_annotation):
            k = round(e.count / n)
            us += k * e.self_device_time_total / e.count
            launches += k
    return us, launches


def print_wall_time_statistics():
    """Print the scope timers and the counters of the global registry."""
    print(_collection.table(), flush=True)
