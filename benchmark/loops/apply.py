"""The ``apply`` loop: a closed loop of chained operator applies, one
client; each apply consumes the previous output over its norm.

The state is the system's draw from the seed (``draw_state``); the chain
starts from it over its norm.  The applies whose input and output are
judged are ``traffic["sample"]`` drawn from the first
``traffic["sample_from"]``, and the last; ``traffic["traced_applies"]``
more run in the traced stretch.  The chain and the state are
``bench_gpu.py``'s (``chained_applies``, ``random_state``), changed: the
state comes from the seed on the card, and the rate is taken over the
whole window, not the best of three windows.  The system gives
``draw_state``, ``apply`` and ``instrument`` (``benchmark/systems/
lattice_operator.py``).
"""

from __future__ import annotations

import time

import torch

from benchmark.harness.spans import Spans
from benchmark.harness.traffic import Run, generator, judged, profiled, sync


def run(system, traffic, seed, seconds, trace, run: Run, t_process):
    dev = system.device
    run.loop = "apply"
    run.state, u = system.draw_state(generator(seed, dev))
    x = u / torch.linalg.vector_norm(u)
    sample = judged(seed, traffic)
    every = int(traffic["check_every"])
    for _ in range(int(traffic["warmup"])):     # every shape, kernels built
        y = system.apply(x)
        x = y / torch.linalg.vector_norm(y)
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError("the warm-up applies left non-finite values")
    sync(dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_process
    n = 0
    while True:
        for _ in range(every):
            y = system.apply(x)
            if n in sample:
                run.answers.append(dict(index=n, x=x.clone(), y=y.clone()))
            x_prev, x = x, y / torch.linalg.vector_norm(y)
            n += 1
        sync(dev)
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.units = run.attempted = n
    if (n - 1) not in sample:
        run.answers.append(dict(index=n - 1, x=x_prev, y=y))
    if trace:
        spans = Spans(dev)
        system.instrument(spans)
        traced = int(traffic["traced_applies"])
        with profiled() as prof:
            for _ in range(traced):
                y = system.apply(x)
                x = y / torch.linalg.vector_norm(y)
            sync(dev)
        run.trace, run.traced_units = prof, traced
        run.attempted += traced
    if not bool(torch.isfinite(x).all()):
        run.failed = 1
    run.n_dofs = system.n_dofs
