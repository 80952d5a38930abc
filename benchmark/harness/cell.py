"""One run of one cell: build, warm up, measure, judge, report.

``run_cell`` returns the result line as a dict; ``benchmark/run.py``
checks for the card and prints it.  The tests call ``run_cell`` on the
CPU with small overrides of the configuration.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from benchmark.harness import spec as specmod
from benchmark.harness import trace as tracemod
from benchmark.harness.traffic import Run, drive

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "ns_gls_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root, workload, seed, seconds, trace, t_process,
             device="cuda", overrides=None, wrap_system=None):
    """The result line of one run (a dict; the compared numbers with
    their limits as its ``checks``), and where set-up went.
    ``overrides``: {"config": ..., "traffic": ...} merged into the cell's
    files (tests);
    ``wrap_system(system)``: called on the built system (tests plant
    faults through it)."""
    bench = specmod.load_benchmark(root)
    cs = specmod.cell_spec(bench, workload, root)
    config = merge(cs["config"], (overrides or {}).get("config", {}))
    traffic = merge(cs["traffic"], (overrides or {}).get("traffic", {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    system = specmod.system_module(config["system"]).System(config, dev)
    t_built = time.perf_counter()
    if wrap_system is not None:
        wrap_system(system)
    run = Run(device=dev, config=config)
    drive(system, traffic, seed, seconds, bool(trace), run, t_process)
    # where set-up went, and the window's steps, for standard error
    run.setup_parts = dict(start_s=t_build - t_process,
                           system_s=t_built - t_build,
                           warmup_s=run.setup_s - (t_built - t_process),
                           steps=[[round(s["seconds"], 4), s["newton"],
                                   s["gmres"]] for s in run.step_stats])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    run.node_pos = system.node_pos
    if run.trace is not None:
        run.trace = tracemod.summarize(run.trace)
    metrics = {}
    for m in cs["per_layer"] if trace else cs["end_to_end"]:
        value = specmod.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the program's state goes before the reference runs
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = specmod.reference_case(config["reference"]).judge(
        config, run, dev)
    limits = config["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (run.attempted > 0 and run.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=run.memory_peak_bytes)
    line = dict(correct=bool(correct), attempted=run.attempted,
                failed=run.failed, metrics=metrics, device=device_info)
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        line["breakdown"] = dict(
            device_ops=[[n[:200], s] for n, s in run.trace["device_ops"]],
            idle_gaps=run.trace["idle_gaps"])
    line["checks"] = checks
    return line, run.setup_parts
