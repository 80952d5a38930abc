"""The general traffic generator: a traffic mix's parameters, read from
``benchmark/traffic/<mix>.json``, drive the closed loop it names
(``"loop"``: ``benchmark/loops/<loop>.py``), its inputs drawn from the
seed; what the loops share is here.

Every loop warms up every shape it uses before the window (counted as
set-up), then runs whole units of work until the first one that ends past
``seconds``; the window is from its start to the end of that unit.  With
``trace`` the window's calls into the program's layers run in fenced
``bench.*`` spans, and after the window a few more units run under
``torch.profiler`` inside a ``bench.window`` span (the traced stretch),
without fences, so that the device's idle share is not the fences'.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark.harness import spec


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    device: torch.device
    loop: str = ""                 # the traffic's loop: solve or apply
    config: dict = None            # the cell's configuration, as run
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                 # driver steps or applies in the window
    attempted: int = 0
    failed: int = 0
    n_dofs: int = 0
    step_stats: list = dataclasses.field(default_factory=list)
    span_seconds: dict = dataclasses.field(default_factory=dict)
    timers: dict = dataclasses.field(default_factory=dict)
    trace: dict = None             # harness.trace.summarize of the stretch
    traced_units: int = 0
    memory_peak_bytes: int = 0
    answers: list = dataclasses.field(default_factory=list)
    state: object = None           # inputs the reference is handed too
    node_pos: object = None        # the program's node positions
    setup_parts: dict = None


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


@contextlib.contextmanager
def profiled():
    """The traced stretch: ``torch.profiler`` over a ``bench.window``
    span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            yield prof


def judged(seed, traffic) -> set:
    """Indices of the units whose answers are judged: ``traffic["sample"]``
    drawn from the seed among the first ``traffic["sample_from"]`` (the
    loop adds the last)."""
    rng = np.random.default_rng(int(seed))
    return set(rng.choice(int(traffic["sample_from"]),
                          size=int(traffic["sample"]), replace=False)
               .tolist())


def drive(system, traffic, seed, seconds, trace, run: Run, t_process):
    """Run the traffic's loop on the system, filling ``run``."""
    spec.loop_module(traffic["loop"]).run(system, traffic, seed, seconds,
                                          trace, run, t_process)
