"""What a run of one cell needs from ``BENCHMARK.json``, found by name.

A cell names a configuration and a traffic mix; the configuration's file
is the one ``BENCHMARK.json`` gives it, the traffic mix is
``benchmark/traffic/<traffic>.json`` and each metric is read by
``benchmark/metrics/<metric name>.py``.  The configuration names the
system under test (``"system"``: ``benchmark/systems/<system>.py``) and
its plain reference (``"reference"``:
``benchmark/reference/cases/<reference>.py``); the mix names the loop
that drives it (``"loop"``: ``benchmark/loops/<loop>.py``).  Adding a
cell, a configuration, a mix, a kind of system or loop, or a metric is
adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_spec(bench: dict, workload: str, root: str) -> dict:
    """The cell's configuration and traffic (parsed files), and the
    metrics it reports: ``end_to_end`` (trace 0) and ``per_layer``
    (trace 1), each a list of the metric entries of ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    traffic_file = os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    with open(traffic_file) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in e2e_names and _applies(m, workload)]
    return dict(cell=cell, config=config, config_entry=config_entry,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def program_params(config: dict) -> dict:
    """The program's parameter dict from the configuration file: its
    ``program`` keys are the reference's JSON keys with ``_`` for each
    space (so that ``reduced`` can name them)."""
    return {k.replace("_", " "): v for k, v in config["program"].items()}


def system_module(name: str):
    """``benchmark/systems/<name>.py``: its ``System(config, device)`` is
    the system under test."""
    return importlib.import_module(f"benchmark.systems.{name}")


def loop_module(name: str):
    """``benchmark/loops/<name>.py``: its ``run(system, traffic, seed,
    seconds, trace, run, t_process)`` drives the system for the window."""
    return importlib.import_module(f"benchmark.loops.{name}")


def reference_case(name: str):
    """``benchmark/reference/cases/<name>.py``: its ``judge(config, run,
    device)`` gives the compared numbers."""
    return importlib.import_module(f"benchmark.reference.cases.{name}")
