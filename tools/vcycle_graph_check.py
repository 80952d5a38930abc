"""The GMG V-cycle replayed from CUDA graphs against the eager cycle, on
the card, for the benchmark's solve configurations.

    python3 tools/vcycle_graph_check.py [--configs turek3d-re20,sphere-amg]
        [--inputs 5] [--seed 7] [--out FILE]

For each configuration (``benchmark/configs/<name>.json``, set up as the
benchmark's ``driver`` system sets it up): two solves from the perturbed
start of the ``solve`` traffic (the first warms up, the second is
reported with its counters and seconds, as a window's solve); then,
after each of two rebuilds (the levels linearized at the solution plus a
perturbation, and ``initialize``), ``--inputs`` seeded sources through
the preconditioner's ``vmult`` (a replay; the first after a rebuild
captures) and through the eager cycle (``_eager_cycle``: the same legs down
and up around the coarse step, uncaptured), compared bit for bit,
with the counters each counted; the seconds of every capture (host
issue, and ``capture_end``, which instantiates the graph); the memory
allocated and its peak around the first capture of the process; the
milliseconds of a replayed and an eager V-cycle, each synchronized.
Prints a JSON line a configuration; ``--out`` also writes them all to a
file.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# counted by the cycle's caller or its graph bookkeeping, not by the cycle
OWN = ("vcycle", "vcycle_graph_capture", "vcycle_graph_replay")


def _bits(t):
    import torch

    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _counted(fn, *args):
    from ns_gls_tpu_torch.utils.timer import counters, counters_since

    before = counters()
    out = fn(*args)
    return out, {k: v for k, v in counters_since(before).items() if v}


def _timed_ms(fn, src, n):
    import torch

    fn(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(src)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def check(name: str, n_inputs: int, seed: int) -> dict:
    import torch

    from benchmark.systems.driver import System
    from ns_gls_tpu_torch.precond import gmg
    from ns_gls_tpu_torch.utils.timer import timer

    bench = os.path.join(ROOT, "benchmark")
    with open(os.path.join(bench, "configs", name + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(bench, "traffic", "solve.json")) as f:
        amp = float(json.load(f)["perturbation"])
    torch.cuda.reset_peak_memory_stats()
    system = System(config, "cuda")
    drv = system.driver
    pc = drv.preconditioner
    gen = torch.Generator(device="cuda").manual_seed(seed)

    # every capture timed: host issue and capture_end (instantiation)
    captures, memory = [], {}
    capture_graph = gmg.capture_graph
    cls = torch.cuda.CUDAGraph
    capture_end = cls.capture_end

    def timed_end(self, *a, **k):
        t0 = time.perf_counter()
        capture_end(self, *a, **k)
        timed_end.seconds = time.perf_counter() - t0

    def timed_capture(fn, device, pool=None):
        if not memory:
            torch.cuda.synchronize()
            memory.update(
                allocated_before=torch.cuda.memory_allocated(),
                peak_before=torch.cuda.max_memory_allocated())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = capture_graph(fn, device, pool)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        captures.append(dict(total_s=total, capture_end_s=timed_end.seconds,
                             issue_s=total - timed_end.seconds))
        if "allocated_after" not in memory:
            memory.update(
                allocated_after=torch.cuda.memory_allocated(),
                peak_after=torch.cuda.max_memory_allocated())
        return out

    gmg.capture_graph = timed_capture
    cls.capture_end = timed_end
    try:
        solves = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = system.solve(system.perturbed_start(gen, amp))
            torch.cuda.synchronize()
            st = system.step_stats()[-1]
            c = st["counters"]
            solves.append(dict(
                seconds=time.perf_counter() - t0, newton=st["newton"],
                allocated=torch.cuda.memory_allocated(),
                peak=torch.cuda.max_memory_allocated(),
                gmres=st["gmres"], drag=rec.get("drag"),
                **{k: c.get(k) for k in (
                    "host_sync", "vcycle", "vcycle_graph_capture",
                    "vcycle_graph_replay", "level_apply", "fine_apply",
                    "amg_cycle", "coarse_gmres_it", "rebuild")}))
        form = pc._form
        rebuilds = []
        for r in range(2):
            u = drv.solution.current
            noise = torch.randn(u.shape, generator=gen, device=u.device,
                                dtype=u.dtype)
            drv._setup_preconditioner(u + 1e-3 * (r + 1) * noise)
            inputs = []
            for k in range(n_inputs):
                src = torch.randn(u.shape, generator=gen, device=u.device,
                                  dtype=u.dtype)
                # each inside a scope: no stage of the cycle is fenced
                with timer("vcycle_graph_check"):
                    got, replayed = _counted(pc.vmult, src)
                with timer("vcycle_graph_check"):
                    want, eager = _counted(pc._eager_cycle, src)
                torch.cuda.synchronize()
                same = bool(torch.equal(_bits(got), _bits(want)))
                own = {k2: replayed.pop(k2, 0) for k2 in OWN}
                inputs.append(dict(
                    bits_equal=same,
                    max_abs_diff=float((got - want).abs().max()),
                    counters_equal=replayed == eager,
                    captured=own["vcycle_graph_capture"],
                    replayed=own["vcycle_graph_replay"]))
            rebuilds.append(inputs)
        src = torch.randn(drv.solution.current.shape, generator=gen,
                          device="cuda", dtype=drv.solution.current.dtype)
        ms = dict(replay=_timed_ms(pc.vmult, src, 20),
                  eager=_timed_ms(pc._eager_cycle, src, 20))
    finally:
        gmg.capture_graph = capture_graph
        cls.capture_end = capture_end
    flat = [x for inputs in rebuilds for x in inputs]
    out = dict(
        config=name, device=torch.cuda.get_device_name(),
        form=form, levels=pc.n_levels,
        coarse=pc.coarse_grid_solver, iterate=pc.coarse_grid_iterate,
        all_bits_equal=all(x["bits_equal"] for x in flat),
        all_counters_equal=all(x["counters_equal"] for x in flat),
        captures_after_rebuilds=[sum(x["captured"] for x in inputs)
                                 for inputs in rebuilds],
        replays=sum(x["replayed"] for x in flat),
        rebuilds=rebuilds, solves=solves, captures=captures,
        memory=memory,
        peak_end=torch.cuda.max_memory_allocated(), vcycle_ms=ms)
    del system, drv, pc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    import subprocess

    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="turek3d-re20,sphere-amg")
    ap.add_argument("--inputs", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from ns_gls_tpu_torch.utils.logging import set_verbose

    set_verbose(False)
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    results = []
    for name in args.configs.split(","):
        res = check(name, args.inputs, args.seed)
        res["power_limit"] = limit.strip()
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = all(r["all_bits_equal"] and r["all_counters_equal"]
             for r in results)
    print("vcycle graph check:", "OK" if ok else "MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
