"""Where a time step of the PyTorch port goes on the GPU.

    python tools/profile_torch_step.py [config] [--warmup 2] [--steps 2]

Runs the config (default ``input/turek_2d_re100.json``, output off)
through the port's ``Driver`` on CUDA for ``--warmup`` steps, then
continues from that state for ``--steps`` more under ``torch.profiler``
and prints: seconds per profiled step, the device busy share (summed
kernel time over wall time), the top device operations by total time,
and the driver's scope timers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


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
    args = ap.parse_args()

    raw = _load_json(args.config)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    recs = drv.run(max_steps=args.warmup)
    sol = [v.cpu().numpy() for v in drv.solution.vectors]
    drv.restart_from(sol, list(drv.time_integrator._dt), recs[-1]["t"],
                     args.warmup + 1)
    get_collection().reset()
    torch.cuda.synchronize()
    n0 = len(drv.step_stats)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.run(max_steps=args.warmup + args.steps)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = drv.step_stats[n0:]

    events = prof.key_averages()

    # kernel-level events only (the aten rows repeat their kernels' time)
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"profiled steps: {len(stats)}, wall {wall:.3f} s "
          f"({wall / max(len(stats), 1):.4f} s/step, profiler on; "
          f"{[round(s['seconds'], 4) for s in stats]} s per step); "
          f"Newton {[s['newton'] for s in stats]}, "
          f"GMRES {[s['gmres'] for s in stats]}")
    print(f"device busy: {busy_us / 1e6:.4f} s = "
          f"{100 * busy_us / 1e6 / wall:.1f}% of wall")
    print(events.table(sort_by="self_device_time_total", row_limit=args.top))
    get_collection().print_all()


if __name__ == "__main__":
    main()
