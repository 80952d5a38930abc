"""Device policy of the port's entry points: CUDA unless the caller asks
for the CPU, and never a silent move to the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is
    requested and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            'pass device="cpu" to run on the CPU'
        )
    return dev


@contextlib.contextmanager
def torch_threads(n: int):
    """Cap torch's intra-op thread pool at ``n`` threads inside the block
    and restore the previous size after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
