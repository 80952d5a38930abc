"""The ``solve`` loop: a closed loop of driver steps, one client.

Each step starts from the configuration's own start plus a perturbation
of ``traffic["perturbation"]`` (absolute, normal) on the nodes off the
boundary, a new draw for each step; the steps whose answers are judged
are ``traffic["sample"]`` drawn from the first ``traffic["sample_from"]``,
and the last; ``traffic["traced_steps"]`` more run in the traced
stretch.  The system gives ``perturbed_start``, ``solve``, ``solution``,
``step_stats``, ``timers`` and ``instrument`` (``benchmark/systems/
driver.py``).
"""

from __future__ import annotations

import sys
import time

from benchmark.harness.spans import Spans
from benchmark.harness.traffic import Run, generator, judged, profiled, sync


def _answer(i, u, rec):
    return dict(index=i, u=u.detach().cpu().numpy(),
                record={k: rec.get(k) for k in ("drag", "lift")})


def run(system, traffic, seed, seconds, trace, run: Run, t_process):
    dev = system.device
    run.loop = "solve"
    gen = generator(seed, dev)
    amp = float(traffic["perturbation"])
    sample = judged(seed, traffic)
    spans = Spans(dev)
    if trace:
        system.instrument(spans)
    system.solve(system.perturbed_start(gen, amp))   # warm-up: every shape
    sync(dev)
    n0 = len(system.step_stats())
    t0 = time.perf_counter()
    run.setup_s = t0 - t_process
    spans.timed = bool(trace)
    last = None

    def step(i):
        run.attempted += 1
        try:
            rec = system.solve(system.perturbed_start(gen, amp))
            sync(dev)
            return rec
        except RuntimeError as exc:
            run.failed += 1
            print(f"step {i} failed: {exc}", file=sys.stderr, flush=True)
            return None

    while True:
        i = run.attempted
        rec = step(i)
        if rec is not None:
            last = (i, system.solution(), rec)
            if i in sample:
                run.answers.append(_answer(i, system.solution(), rec))
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.units = run.attempted
    run.step_stats = system.step_stats()[n0:]
    run.span_seconds = dict(spans.seconds)
    if last is not None and last[0] not in sample:
        run.answers.append(_answer(*last))
    if trace:
        spans.timed = False
        n = int(traffic["traced_steps"])
        with profiled() as prof:
            for _ in range(n):
                step(run.attempted)
        run.trace, run.traced_units = prof, n
    run.timers = system.timers()
    run.n_dofs = system.n_dofs
