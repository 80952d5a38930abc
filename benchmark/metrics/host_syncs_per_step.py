"""Host syncs a driver step: the program's ``host_sync`` counter (reads of
device tensors on the host and copies of host values to the device, each
a wait for the stream; ``ns_gls_tpu_torch/utils/timer.py``), from the
per-step counters of ``Driver.step_stats``, over the window's steps."""

from benchmark.harness.program import per_step


def read(run):
    return per_step(run, "host_sync")
