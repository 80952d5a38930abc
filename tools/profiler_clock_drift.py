"""How far ``torch.profiler`` places kernels from their host launches as
the process ages.

    python3 tools/profiler_clock_drift.py [--iterations 6] [--sleep 30]

Every ``--sleep`` seconds, profiles 20 launches of one elementwise kernel
(CPU and CUDA activities) and prints how many kernels the trace kept and
the offset, in microseconds, between each kept kernel's device start and
its ``cudaLaunchKernel`` on the host.  A kernel whose converted device
timestamp falls after the profiler's window closes is not in the trace:
a growing offset means short windows late in a long process lose their
last kernels (``ns_gls_tpu_torch/utils/timer.py`` pads its windows for
this).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=6)
    ap.add_argument("--sleep", type=float, default=30.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_clock_drift: no CUDA device")
        return 2
    x = torch.zeros(1 << 20, device="cuda")
    t_start = time.perf_counter()
    for it in range(args.iterations):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                x.add_(1.0)
            torch.cuda.synchronize()
        ev = prof.events()
        launches = sorted(e.time_range.start for e in ev
                          if e.name == "cudaLaunchKernel")
        kernels = sorted(e.time_range.start for e in ev
                         if e.device_type == DeviceType.CUDA
                         and not e.is_user_annotation)
        d = [k - h for k, h in zip(kernels, launches)]
        print(f"t={time.perf_counter() - t_start:.1f} s: {len(launches)} "
              f"launches, {len(kernels)} kernels in the trace; "
              f"kernel - launch offset {min(d, default=float('nan')):.1f} "
              f"to {max(d, default=float('nan')):.1f} us", flush=True)
        if it + 1 < args.iterations:
            time.sleep(args.sleep)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
