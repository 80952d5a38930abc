"""The program's own spans and counters, as a run records them.

Spans: while a profiler records, each scope of the program's recorder
(``ns_gls_tpu_torch/utils/timer.py``) is a ``record_function`` range
``ns.<label>``, its label the scope's ``parent::child`` path, so that
the trace holds it on the device operations' clock.  ``summarize`` reads
them from the events of a traced stretch: for each label its calls, its
host seconds, the device seconds it owns (each device operation goes to
the innermost ``ns.*`` range whose device-side annotation holds it) and
the idle seconds it owns (each idle gap of the device goes to the
innermost ``ns.*`` host span open where the gap starts).  The busy time
is the union of the device operations' intervals, as in
``harness/trace.py``, each stretch of it owned once; so on one stream
the owned seconds of all labels and the unowned part add up to the
stretch.  ``idle_gaps`` labels the gaps by the innermost span of either
family, ``bench.*`` or ``ns.*``.

Counters: each ``Driver.step_stats`` record holds ``counters``, every
counter's change over that step; ``per_step`` averages one over the
window's steps.

A program without these spans or counters gives empty tables and
``None``: nothing here raises on it.
"""

from __future__ import annotations

from collections import defaultdict

PREFIX = "ns."
BENCH = "bench."
WINDOW = BENCH + "window"


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def window(events) -> tuple:
    """(start, end) of the ``bench.window`` host span, in µs, or of all
    the events where there is none."""
    for e in events:
        if e.name == WINDOW and not _is_device(e):
            return e.time_range.start, e.time_range.end
    return (min(e.time_range.start for e in events),
            max(e.time_range.end for e in events))


def _owners(spans, queries) -> list:
    """For each query (a, b), in the order of a, the name of the
    latest-starting span of ``spans`` [(start, end, name)] that holds
    [a, b], or None: one sweep with a stack of the spans begun."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for a, b in queries:
        while j < len(spans) and spans[j][0] <= a:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < a:
            stack.pop()
        k = len(stack) - 1
        while k >= 0 and stack[k][1] < b:
            k -= 1
        out.append(stack[k][2] if k >= 0 else None)
    return out


def _busy_parts(events, w0, w1):
    """The device operations clipped to the stretch, sorted, each with
    the part of the busy union it adds first and its name, and the idle
    gaps."""
    ops = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1),
                  e.name)
                 for e in events
                 if _is_device(e) and not e.is_user_annotation
                 and e.time_range.end > w0 and e.time_range.start < w1)
    parts, gaps = [], []
    cur_end = w0
    for a, b, name in ops:
        if a > cur_end:
            gaps.append((cur_end, a))
        new = 0.0
        if b > cur_end:
            new = b - max(a, cur_end)
            cur_end = b
        parts.append((a, b, new, name))
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    return parts, gaps


def _host_spans(events, w0, w1, prefixes):
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if not _is_device(e) and e.name != WINDOW
                  and e.name.startswith(prefixes)
                  and e.time_range.end > w0 and e.time_range.start < w1)


def summarize(events, w0=None, w1=None, top: int = 3) -> dict:
    """The program's spans over the stretch [w0, w1] (µs; by default
    ``window(events)``): ``labels`` {label: {calls, host_s, device_s,
    idle_s}} with the labels without the ``ns.`` prefix, and
    ``unowned_device_s``, ``unowned_idle_s``, ``busy_s``, ``window_s``,
    and ``top_ops`` {label: [[device operation, owned seconds], ...]},
    the ``top`` operations each label owns most of."""
    events = list(events)
    if w0 is None:
        w0, w1 = window(events)
    host = _host_spans(events, w0, w1, (PREFIX,))
    annotations = sorted((e.time_range.start, e.time_range.end, e.name)
                         for e in events
                         if _is_device(e) and e.is_user_annotation
                         and e.name.startswith(PREFIX))
    labels = defaultdict(lambda: dict(calls=0, host_s=0.0, device_s=0.0,
                                      idle_s=0.0))
    for a, b, name in host:
        rec = labels[name[len(PREFIX):]]
        rec["calls"] += 1
        rec["host_s"] += (b - a) / 1e6
    parts, gaps = _busy_parts(events, w0, w1)
    unowned_device = unowned_idle = busy = 0.0
    by_op = defaultdict(lambda: defaultdict(float))
    for (a, b, new, op), owner in zip(parts, _owners(
            annotations, [(a, b) for a, b, _, _ in parts])):
        busy += new
        if owner is None:
            unowned_device += new
        else:
            labels[owner[len(PREFIX):]]["device_s"] += new / 1e6
            by_op[owner[len(PREFIX):]][op] += new / 1e6
    for (a, b), owner in zip(gaps, _owners(host, [(a, a) for a, _ in gaps])):
        if owner is None:
            unowned_idle += b - a
        else:
            labels[owner[len(PREFIX):]]["idle_s"] += (b - a) / 1e6
    top_ops = {k: [[n, v] for n, v in sorted(d.items(),
                                             key=lambda kv: -kv[1])[:top]]
               for k, d in by_op.items()}
    return dict(labels=dict(labels), unowned_device_s=unowned_device / 1e6,
                unowned_idle_s=unowned_idle / 1e6, busy_s=busy / 1e6,
                window_s=(w1 - w0) / 1e6, top_ops=top_ops)


def idle_gaps(events, w0=None, w1=None, top: int = 10) -> list:
    """The idle seconds of the stretch by the innermost host span of
    either family (``bench.*``, ``ns.*``) open where each gap starts,
    most first: [[label, seconds], ...]."""
    events = list(events)
    if w0 is None:
        w0, w1 = window(events)
    spans = _host_spans(events, w0, w1, (BENCH, PREFIX))
    gaps = _busy_parts(events, w0, w1)[1]
    idle = defaultdict(float)
    for (a, b), owner in zip(gaps, _owners(spans, [(a, a) for a, _ in gaps])):
        idle[owner or "outside any span"] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(idle.items(),
                                      key=lambda kv: -kv[1])[:top]]


def _matches(label: str, stage: str, descendants: bool) -> bool:
    ends = label == stage or label.endswith("::" + stage)
    return ends or (descendants and (label.startswith(stage + "::")
                                     or "::" + stage + "::" in label))


def owned(program: dict, stage: str, descendants: bool = True) -> dict:
    """Calls, device and idle seconds owned by the labels that end with
    ``stage`` (``a::b`` matches ``x::a::b``), with their descendants'
    unless ``descendants`` is false; calls count the stage's own."""
    out = dict(calls=0, device_s=0.0, idle_s=0.0)
    for label, rec in program["labels"].items():
        if _matches(label, stage, descendants):
            out["device_s"] += rec["device_s"]
            out["idle_s"] += rec["idle_s"]
            if _matches(label, stage, False):
                out["calls"] += rec["calls"]
    return out


def span_metrics(program: dict, steps: int) -> dict:
    """The per-layer readings of a traced stretch of ``steps`` driver
    steps from its program spans; a reading whose spans are absent is
    None."""
    def seconds(o):
        return o["device_s"] + o["idle_s"]

    def per_step(stage, descendants=True):
        o = owned(program, stage, descendants)
        return seconds(o) / steps if o["calls"] and steps else None

    def idle_pct(stage):
        o = owned(program, stage)
        return (100.0 * o["idle_s"] / seconds(o)
                if o["calls"] and seconds(o) > 0 else None)

    coarse = [owned(program, "mg_init::coarse_" + k)
              for k in ("lu", "amg", "ilu")]
    vcycle = owned(program, "vcycle", False)
    vc_coarse = owned(program, "vcycle::coarse")
    return dict(
        level_state_s_per_step=per_step(
            "setup_preconditioner::level_state", False),
        diag_s_per_step=per_step("mg_init::diagonal"),
        power_s_per_step=per_step("mg_init::power_iteration"),
        coarse_setup_s_per_step=(
            sum(seconds(o) for o in coarse) / steps
            if steps and any(o["calls"] for o in coarse) else None),
        vcycle_coarse_ms=(1e3 * seconds(vc_coarse) / vcycle["calls"]
                          if vcycle["calls"] and vc_coarse["calls"]
                          else None),
        vcycle_idle_pct=idle_pct("vcycle"),
        rebuild_idle_pct=idle_pct("setup_preconditioner"),
    )


def per_step(run, counter: str):
    """The mean change of ``counter`` a driver step over the window's
    steps (``Driver.step_stats`` ``counters``), or None where a step has
    no such counter."""
    stats = [s.get("counters") for s in run.step_stats]
    if not stats or any(c is None or counter not in c for c in stats):
        return None
    return sum(c[counter] for c in stats) / len(stats)
