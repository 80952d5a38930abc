"""Reading a ``torch.profiler`` trace of the traced stretch of a run.

Copied from the program's ``tools/profile_torch_step.py`` (busy share,
top device operations, ``kernels_in_scope``) and changed: the busy time
is the union of the device operations' intervals inside the stretch, not
their sum (a sum counts overlapping streams twice); the stretch is the
host span ``bench.window``; idle gaps are labelled by the innermost
``bench.*`` host span open when they start.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "bench.window"


def _device_ops(events):
    from torch.autograd import DeviceType

    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def summarize(prof, top: int = 10) -> dict:
    """busy_s and window_s of the stretch, the device operations that took
    most time and the longest idle gaps by host span, and the device
    seconds and calls of each ``bench.*`` scope's kernels."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("bench.")]
    wins = [e for e in host if e.name == WINDOW]
    if not wins:
        raise RuntimeError("the trace holds no bench.window span")
    w0, w1 = wins[0].time_range.start, wins[0].time_range.end
    ops = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1),
                  e.name) for e in _device_ops(events)
                 if e.time_range.end > w0 and e.time_range.start < w1)
    # union of the intervals, and the gaps between them
    busy = 0
    gaps = []
    cur_end = w0
    for a, b, _ in ops:
        if a > cur_end:
            gaps.append((cur_end, a))
        if b > cur_end:
            busy += b - max(a, cur_end)
            cur_end = b
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    by_name = defaultdict(float)
    for a, b, name in ops:
        by_name[name] += (b - a) / 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host if e.name != WINDOW)
    starts = [s[0] for s in spans]
    idle = defaultdict(float)
    for a, b in gaps:
        label = "outside any span"
        i = bisect.bisect_right(starts, a) - 1
        while i >= 0:
            if spans[i][1] >= a:
                label = spans[i][2]
                break
            i -= 1
        idle[label] += (b - a) / 1e6
    scopes = {}
    for name in {s[2] for s in spans}:
        scopes[name] = (kernels_in_scope(events, name),
                        sum(1 for s in spans if s[2] == name))
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
                device_ops=[[k, v] for k, v in rank(by_name)],
                idle_gaps=[[k, v] for k, v in rank(idle)],
                scopes=scopes)


def kernels_in_scope(events, name: str) -> float:
    """Seconds of device time of the operations that ran inside the device
    ranges of the profiler scope ``name``."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name and e.device_type == DeviceType.CUDA)
    starts = [a for a, _ in spans]
    total = 0
    for e in _device_ops(events):
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            total += e.time_range.end - e.time_range.start
    return total / 1e6
