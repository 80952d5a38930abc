"""CPU tests of ``benchmark/harness/program.py``: the program's spans
(``ns.*``) in a synthetic trace, owned once each; the idle gaps by the
innermost span of either family; ``harness/trace.py``'s summary the same
with and without the program's spans; the counter metrics on the solve
cell, and none on the vmult cell or on a program without counters."""

import json
import os
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark.harness import program, spec, trace
from benchmark.harness.cell import run_cell
from benchmark.harness.traffic import Run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOLVE = "turek3d-re20.solve"
COUNTER_METRICS = {"host_syncs_per_step": "host_sync",
                   "fine_applies_per_step": "fine_apply",
                   "level_applies_per_step": "level_apply"}


def ev(name, start, end, device=False, annotation=False):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=SimpleNamespace(start=float(start), end=float(end)))


def host_and_device(name, start, end, d_start, d_end):
    """A ``record_function`` range: its host span and its device-side
    annotation."""
    return [ev(name, start, end), ev(name, d_start, d_end, True, True)]


def synthetic(with_program=True) -> list:
    """A stretch of 0-1000 µs: a ``bench.vcycle`` span holding the
    program's ``ns.v`` and its stages ``ns.v::s`` (twice) and ``ns.v::c``,
    then a ``bench.gmres`` span with kernels of its own; device operations
    in and between them, one across the stretch's start."""
    evs = [ev("bench.window", 0, 1000),
           ev("bench.vcycle", 10, 500), ev("bench.gmres", 520, 990),
           ev("k0", -20, 15, True),
           ev("k1", 30, 60, True), ev("k2", 50, 80, True),
           ev("k3", 120, 150, True), ev("k4", 200, 260, True),
           ev("k5", 300, 310, True), ev("k6", 600, 700, True),
           ev("k7", 720, 730, True), ev("k8", 995, 1010, True)]
    if with_program:
        evs += host_and_device("ns.v", 20, 480, 30, 310)
        evs += host_and_device("ns.v::s", 25, 90, 30, 80)
        evs += host_and_device("ns.v::s", 100, 140, 120, 150)
        evs += host_and_device("ns.v::c", 150, 290, 200, 260)
        evs += host_and_device("ns.g", 580, 710, 600, 700)
    return evs


def test_owned_seconds_add_up_to_the_stretch():
    p = program.summarize(synthetic())
    assert p["window_s"] == pytest.approx(1e-3)
    lab = p["labels"]
    owned = sum(r["device_s"] + r["idle_s"] for r in lab.values())
    assert owned + p["unowned_device_s"] + p["unowned_idle_s"] \
        == pytest.approx(p["window_s"], abs=1e-15)
    busy = trace.summarize(SimpleNamespace(events=synthetic))["busy_s"]
    assert p["busy_s"] == pytest.approx(busy, abs=1e-15)
    # the union, each part owned once: k1 and k2 overlap (30-80)
    assert lab["v::s"]["device_s"] == pytest.approx(80e-6)     # 50 + 30
    assert lab["v::c"]["device_s"] == pytest.approx(60e-6)     # k4
    assert lab["v"]["device_s"] == pytest.approx(10e-6)        # k5
    assert lab["g"]["device_s"] == pytest.approx(100e-6)       # k6
    assert dict(p["top_ops"]["v::s"]) == pytest.approx(
        {"k1": 30e-6, "k2": 20e-6, "k3": 30e-6})
    assert lab["v::s"]["calls"] == 2 and lab["v"]["calls"] == 1
    assert lab["v::s"]["host_s"] == pytest.approx(105e-6)
    # each gap to the span open where it starts: 80-120 in v::s (25-90),
    # 150-200 and 260-300 in v::c (150-290), 310-600 in v, 700-720 in g
    assert lab["v::s"]["idle_s"] == pytest.approx(40e-6)
    assert lab["v::c"]["idle_s"] == pytest.approx(90e-6)
    assert lab["v"]["idle_s"] == pytest.approx(290e-6)
    assert lab["g"]["idle_s"] == pytest.approx(20e-6)
    # k0 (15), k7 (10) and k8 (5); the gaps 15-30 and 730-995
    assert p["unowned_device_s"] == pytest.approx(30e-6)
    assert p["unowned_idle_s"] == pytest.approx(280e-6)


def test_innermost_owner():
    """An operation inside a stage's device annotation goes to the stage;
    one inside only the parent's to the parent; one inside none to no
    label."""
    p = program.summarize([
        ev("bench.window", 0, 100), *host_and_device("ns.a", 0, 90, 10, 80),
        *host_and_device("ns.a::b", 5, 40, 10, 30),
        ev("k", 10, 20, True), ev("k", 40, 50, True), ev("k", 85, 95, True)])
    lab = p["labels"]
    assert lab["a::b"]["device_s"] == pytest.approx(10e-6)
    assert lab["a"]["device_s"] == pytest.approx(10e-6)
    assert p["unowned_device_s"] == pytest.approx(10e-6)


def test_idle_gaps_by_innermost_of_either_family():
    gaps = dict(program.idle_gaps(synthetic()))
    # 15-30 starts before ns.v opens (20): bench.vcycle's; 310-600 in
    # ns.v, which opened after bench.vcycle
    assert gaps == pytest.approx({
        "bench.vcycle": 15e-6, "ns.v::s": 40e-6, "ns.v::c": 90e-6,
        "ns.v": 290e-6, "ns.g": 20e-6, "bench.gmres": 265e-6})
    assert sum(gaps.values()) == pytest.approx(
        1e-3 - trace.summarize(SimpleNamespace(
            events=synthetic))["busy_s"], abs=1e-15)
    # without the program's spans the bench.* labels alone, as trace.py
    plain = trace.summarize(SimpleNamespace(events=lambda: synthetic(
        False)))
    assert program.idle_gaps(synthetic(False)) == plain["idle_gaps"]


def test_trace_summary_unchanged_by_program_spans():
    with_p = trace.summarize(SimpleNamespace(events=synthetic))
    without = trace.summarize(SimpleNamespace(events=lambda: synthetic(
        False)))
    assert with_p == without
    assert with_p["busy_s"] == pytest.approx(
        (15 + 50 + 30 + 60 + 10 + 100 + 10 + 5) * 1e-6)


def test_owned_and_span_metrics():
    labels = {
        "loop::setup_preconditioner": dict(calls=2, host_s=0, device_s=1.0,
                                           idle_s=1.0),
        "loop::setup_preconditioner::level_state": dict(
            calls=2, host_s=0, device_s=0.2, idle_s=0.2),
        "loop::setup_preconditioner::mg_init::diagonal": dict(
            calls=4, host_s=0, device_s=0.6, idle_s=0.0),
        "loop::setup_preconditioner::mg_init::power_iteration": dict(
            calls=4, host_s=0, device_s=0.1, idle_s=0.3),
        "loop::setup_preconditioner::mg_init::coarse_amg": dict(
            calls=2, host_s=0, device_s=0.0, idle_s=0.1),
        "loop::setup_preconditioner::mg_init::coarse_amg::amg_init::refresh":
            dict(calls=2, host_s=0, device_s=0.3, idle_s=0.1),
        "loop::solve_with_jacobian::vcycle": dict(calls=10, host_s=0,
                                                  device_s=0.0, idle_s=0.2),
        "loop::solve_with_jacobian::vcycle::smooth": dict(
            calls=40, host_s=0, device_s=0.5, idle_s=0.1),
        "loop::solve_with_jacobian::vcycle::coarse": dict(
            calls=10, host_s=0, device_s=0.05, idle_s=0.15),
    }
    m = program.span_metrics(dict(labels=labels), steps=2)
    assert m["level_state_s_per_step"] == pytest.approx(0.2)
    assert m["diag_s_per_step"] == pytest.approx(0.3)
    assert m["power_s_per_step"] == pytest.approx(0.2)
    assert m["coarse_setup_s_per_step"] == pytest.approx(0.25)
    assert m["vcycle_coarse_ms"] == pytest.approx(20.0)
    assert m["vcycle_idle_pct"] == pytest.approx(100 * 0.45 / 1.0)
    assert m["rebuild_idle_pct"] == pytest.approx(
        100 * 1.7 / (1.7 + 2.2))
    assert all(v is None for v in program.span_metrics(
        dict(labels={}), steps=2).values())


def test_counter_metrics_without_counters_read_none():
    """The vmult cell's run (no driver steps) and a program whose steps
    have no counters give no reading, and nothing raises."""
    runs = [Run(device=torch.device("cpu"), loop="apply", units=5),
            Run(device=torch.device("cpu"), loop="solve", units=2,
                step_stats=[dict(newton=4, gmres=44, seconds=3.0)] * 2)]
    for name in COUNTER_METRICS:
        for run in runs:
            assert spec.metric_reader(name)(run) is None


def test_counter_metrics_on_the_solve_cell():
    """A traced run of the solve cell, cut to Q1 at refinement 0 on the
    CPU: the three counter metrics read the steps' counters."""
    ov = {"config": {"program": {"n_global_refinements": 0,
                                 "fe_degree": 1}}}
    line = run_cell(ROOT, SOLVE, 2 ** 31 + 11, 0.05, 1, time.perf_counter(),
                    device="cpu", overrides=ov)[0]
    m = line["metrics"]
    json.dumps(line)
    for name in COUNTER_METRICS:
        assert m[name]["value"] > 0, name
    assert m["fine_applies_per_step"]["value"] \
        > m["gmres_per_step"]["value"]
    assert m["level_applies_per_step"]["value"] \
        > m["fine_applies_per_step"]["value"]
