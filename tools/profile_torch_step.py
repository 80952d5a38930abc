"""Where a time step of the PyTorch port goes on the GPU.

    python tools/profile_torch_step.py [config] [--warmup 2] [--steps 2]
        [--dim D] [--degree P] [--refinements R] [--sample N [--skip K]]

Runs the config (default ``input/turek_2d_re100.json``, output off;
``--dim``, ``--degree`` and ``--refinements`` override its "dim", "fe
degree" and "n global refinements", e.g. ``input/channel.json --dim 3
--degree 2 --refinements 3``) through the port's ``Driver`` on CUDA for ``--warmup`` steps, then
continues from that state for ``--steps`` more under ``torch.profiler``
(a stationary config, e.g. ``input/sphere_amg.json``, is one solve: the
warm-up solves it and the profiled run solves it again from the start)
and prints: seconds per profiled step, the device busy share (summed
kernel time over the profiled steps' seconds, and over the profiled wall,
which also holds the profiler's start and stop), the top device operations
by total time, for each fused kernel its launches, device time, and time
above its bound per step (each apply's bound at its level's shape,
``utils/roofline.py``), the weak-outflow face sweep's calls, host and
device time where the config has outflow faces (a ``face_sweep``
profiler scope around each call), and the driver's scope timers.

A step of thousands of GMRES iterations (``input/hoffmann_2d_reinf.json``:
~1,800) holds millions of operations, more events than the profiler can
hold in a 96 GiB host: ``--sample N`` records only a window of N
preconditioner applications (one per outer GMRES iteration) of the
profiled steps, after ``--skip K`` of them, and prints the same shares
over the window's wall time (the step's own totals from the driver).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count_sweeps(drv):
    """Wrap the fused sweep of every operator (the levels and the outer
    one) so that each apply adds its kernel launches and their bound
    (``utils/roofline.py``, at the level's shape and the apply's flavor)
    to its kernel's tally.  Returns {kernel function name: [launches,
    summed bound ms]}; an apply launches its kernel once, or once a patch
    family on a patch-2D level of several families."""
    from ns_gls_tpu_torch.ops.patch2d import Patch2DSweep
    from ns_gls_tpu_torch.ops.patch3d import Patch3DSweep
    from ns_gls_tpu_torch.ops.prism import PrismSweep
    from ns_gls_tpu_torch.utils import roofline as rl

    costs = ((Patch2DSweep, rl.patch2d_cost), (PrismSweep, rl.prism_cost),
             (Patch3DSweep, rl.patch3d_cost))
    tally = {}
    for op in [drv.op] + list(drv.mg_ops):
        sw = op._fast
        if sw is None:
            continue
        cost = next((c for cls, c in costs if isinstance(sw, cls)),
                    rl.structured_cost)
        if cost is rl.structured_cost:
            name = (f"structured{sw.tables.d}d"
                    f"{'_batched' if sw.batched else ''}_kernel")
        else:
            name = {rl.patch2d_cost: "patch2d_kernel",
                    rl.prism_cost: "prism_kernel",
                    rl.patch3d_cost: "patch3d_kernel"}[cost]
        entry = tally.setdefault(name, [0, 0.0])
        bounds = {}

        def counted(weight, stau, uP, ulP, voP, flavor, sw=sw, cost=cost,
                    entry=entry, bounds=bounds, apply=sw.apply):
            if flavor not in bounds:
                bounds[flavor] = rl.bound(*cost(
                    sw.tables, flavor, sw.consider_dt, sw.cell_wise))[0]
            entry[0] += len(sw.tables.fams) if cost is rl.patch2d_cost else 1
            entry[1] += bounds[flavor]
            return apply(weight, stau, uP, ulP, voP, flavor)

        sw.apply = counted
    return tally


def annotate_face_sweeps(drv, counting):
    """Put every operator's weak-outflow face sweep in a ``face_sweep``
    profiler scope, and add its calls and host seconds to a tally while
    ``counting()`` holds; returns the tally, or None where no operator
    has outflow faces."""
    from torch.profiler import record_function

    tally = None
    for op in [drv.op] + list(drv.mg_ops):
        if not op.needs_face_integrals:
            continue
        tally = tally or {"calls": 0, "host_s": 0.0}

        def scoped(u, r, residual_form, sweep=op._boundary_sweep,
                   tally=tally):
            t0 = time.perf_counter()
            with record_function("face_sweep"):
                out = sweep(u, r, residual_form)
            if counting():
                tally["calls"] += 1
                tally["host_s"] += time.perf_counter() - t0
            return out

        op._boundary_sweep = scoped
    return tally


def kernels_in_scope(prof, name: str) -> float:
    """Seconds of device time of the kernels that ran inside the device
    ranges of the profiler scope ``name`` (the scope's own device time
    also counts the idle gaps between them)."""
    import bisect

    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name == name and e.device_type == DeviceType.CUDA)
    starts = [a for a, _ in spans]
    total = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            total += e.time_range.end - e.time_range.start
    return total / 1e6


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.logging import set_verbose
    from ns_gls_tpu_torch.utils.timer import get_collection

    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?",
                    default=os.path.join(ROOT, "input", "turek_2d_re100.json"))
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--dim", type=int, default=None)
    ap.add_argument("--degree", type=int, default=None)
    ap.add_argument("--refinements", type=int, default=None)
    ap.add_argument("--sample", type=int, default=0,
                    help="profile a window of this many preconditioner "
                    "applications only")
    ap.add_argument("--skip", type=int, default=50,
                    help="preconditioner applications before the window")
    args = ap.parse_args()

    # the window: preconditioner applications after --skip, --sample long
    marks = (args.skip + 1, args.skip + 1 + args.sample)
    raw = _load_json(args.config)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    for key, value in (("dim", args.dim), ("fe degree", args.degree),
                       ("n global refinements", args.refinements)):
        if value is not None:
            raw[key] = value
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    drv._setup_done = True
    start = [v.cpu().numpy() for v in drv.solution.vectors]
    drv.run(max_steps=args.warmup)
    if drv.time_integrator.order == 0:
        # a stationary config is one solve: profile it again from its start
        sol, dts, t, counter = start, [], 0.0, 1
    else:
        sol = [v.cpu().numpy() for v in drv.solution.vectors]
        dts, t = list(drv.time_integrator._dt), drv.time_reached
        counter = args.warmup + 1
    drv.restart_from(sol, dts, t, counter)
    get_collection().reset()
    tally = count_sweeps(drv)
    window = {}
    faces = annotate_face_sweeps(
        drv, lambda: not args.sample
        or marks[0] <= window.get("n", 0) < marks[1])
    torch.cuda.synchronize()
    n0 = len(drv.step_stats)
    sched = None
    if args.sample:
        sched = torch.profiler.schedule(wait=args.skip, warmup=1,
                                        active=args.sample, repeat=1)
        apply = drv.preconditioner.vmult

        def sampled(src):
            out = apply(src)
            window["n"] = n = window.get("n", 0) + 1
            prof.step()
            if n in marks:
                torch.cuda.synchronize()
                window[n] = time.perf_counter()
            return out

        drv.preconditioner.vmult = sampled
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        drv.run(max_steps=counter - 1 + args.steps)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = drv.step_stats[n0:]
    if args.sample:
        if not all(m in window for m in marks):
            raise SystemExit(f"the profiled steps made {window.get('n', 0)} "
                             f"preconditioner applications, fewer than "
                             f"--skip {args.skip} + --sample {args.sample}")
        wall = window[marks[1]] - window[marks[0]]
        print(f"sampled window: preconditioner applications "
              f"{marks[0] + 1}-{marks[1]} of the profiled steps' "
              f"{window['n']}, {wall:.4f} s of wall time; the shares below "
              f"are over the window")

    events = prof.key_averages()

    # kernel-level events only (the aten rows repeat their kernels' time)
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    import subprocess

    print("device: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    print(f"{drv.mesh.n_cells} cells, "
          f"{drv.space.n_nodes * (drv.params.dim + 1)} DoFs, "
          f"{len(drv.mg_ops)} GMG levels")
    print(f"profiled steps: {len(stats)}, "
          + ("" if args.sample else
             f"wall {wall:.3f} s ({wall / max(len(stats), 1):.4f} s/step), ")
          + f"{[round(s['seconds'], 4) for s in stats]} s per step with the "
          f"profiler on; Newton {[s['newton'] for s in stats]}, "
          f"GMRES {[s['gmres'] for s in stats]}")
    # both shares: ``wall`` also holds the profiler's start and stop,
    # which dwarf a short window; the steps' own seconds do not
    step_s = wall if args.sample else sum(s["seconds"] for s in stats)
    busy_s = busy_us / 1e6
    print(f"device busy: {busy_s:.4f} s = "
          f"{100 * busy_s / max(step_s, 1e-9):.1f}% of the profiled "
          f"{'window' if args.sample else 'steps'}' {step_s:.3f} s, "
          f"{100 * busy_s / wall:.1f}% of the profiled wall {wall:.3f} s")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top))
    # the fused kernels against their bounds: device time over the
    # profiled steps (or the window) less the summed bound of their
    # launches (each at the average bound of the profiled steps' applies)
    span = "the window" if args.sample else f"{len(stats)} profiled step(s)"
    for name, (launches, bound_ms) in tally.items():
        rows = [e for e in events if e.device_type == DeviceType.CUDA
                and (f"{name}(" in e.key or f"{name}<" in e.key)]
        dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
        n = sum(e.count for e in rows)
        per_launch = bound_ms / max(launches, 1)
        above = dev_ms - n * per_launch
        print(f"fused kernel {name}: {n} launches in {span} ({launches} "
              f"by the sweep applies of the profiled steps), "
              f"{dev_ms:.3f} ms of "
              f"device time, {1e3 * dev_ms / max(n, 1):.1f} us per launch "
              f"on average; bound {1e3 * per_launch:.2f} us per launch on "
              f"average; above the bound {above:.3f} ms in {span}"
              + ("" if args.sample else
                 f" ({above / max(len(stats), 1):.3f} ms per step)"))
    if faces is not None:
        dev_s = kernels_in_scope(prof, "face_sweep")
        print(f"face sweep: {faces['calls']} calls in {span}, host "
              f"{faces['host_s']:.4f} s "
              f"({100 * faces['host_s'] / max(step_s, 1e-9):.1f}% of the "
              f"wall time), kernels {dev_s:.4f} s of device time "
              f"({100 * dev_s / max(busy_s, 1e-12):.1f}% of the device busy "
              f"time)")
    get_collection().print_all()


if __name__ == "__main__":
    main()
