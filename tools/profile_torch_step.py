"""Where a time step of the PyTorch port goes on the GPU.

    python tools/profile_torch_step.py [config] [--warmup 2] [--steps 2]
        [--dim D] [--degree P] [--refinements R]

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
``utils/roofline.py``), and the driver's scope timers.
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
    one) so that each apply adds its bound (``utils/roofline.py``, at the
    level's shape and the apply's flavor) to its kernel's tally.  Returns
    {kernel function name: [applies, summed bound ms]}; every apply
    launches its kernel once."""
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
            entry[0] += 1
            entry[1] += bounds[flavor]
            return apply(weight, stau, uP, ulP, voP, flavor)

        sw.apply = counted
    return tally


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
    args = ap.parse_args()

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
    torch.cuda.synchronize()
    n0 = len(drv.step_stats)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.run(max_steps=counter - 1 + args.steps)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = drv.step_stats[n0:]

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
    print(f"profiled steps: {len(stats)}, wall {wall:.3f} s "
          f"({wall / max(len(stats), 1):.4f} s/step, profiler on; "
          f"{[round(s['seconds'], 4) for s in stats]} s per step); "
          f"Newton {[s['newton'] for s in stats]}, "
          f"GMRES {[s['gmres'] for s in stats]}")
    # both shares: ``wall`` also holds the profiler's start and stop,
    # which dwarf a short window; the steps' own seconds do not
    step_s = sum(s["seconds"] for s in stats)
    busy_s = busy_us / 1e6
    print(f"device busy: {busy_s:.4f} s = "
          f"{100 * busy_s / max(step_s, 1e-9):.1f}% of the profiled "
          f"steps' {step_s:.3f} s, {100 * busy_s / wall:.1f}% of the "
          f"profiled wall {wall:.3f} s")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top))
    # the fused kernels against their bounds: device time over the
    # profiled steps less the summed bound of their launches, per step
    for name, (applies, bound_ms) in tally.items():
        rows = [e for e in events if e.device_type == DeviceType.CUDA
                and (f"{name}(" in e.key or f"{name}<" in e.key)]
        dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
        n = sum(e.count for e in rows)
        print(f"fused kernel {name}: {n} launches ({applies} sweep "
              f"applies) in {len(stats)} profiled step(s), {dev_ms:.3f} ms "
              f"of device time, {1e3 * dev_ms / max(n, 1):.1f} us per "
              f"launch on average; summed bound {bound_ms:.3f} ms "
              f"({1e3 * bound_ms / max(applies, 1):.2f} us per launch on "
              f"average); above the bound "
              f"{(dev_ms - bound_ms) / max(len(stats), 1):.3f} ms per step")
    get_collection().print_all()


if __name__ == "__main__":
    main()
