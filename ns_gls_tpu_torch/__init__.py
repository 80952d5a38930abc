"""ns_gls_tpu_torch — the PyTorch/CUDA port of the GLS-stabilized
incompressible Navier-Stokes solver (equal-order Q_k/Q_k elements,
SUPG/PSPG/grad-div stabilization).

Plain tensor code is PyTorch; the fused patch-2D GLS sweep is a CUDA C++
kernel for Hopper (``csrc/patch2d.cu``), built from the sources at first
use.  Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU with ``device="cpu"``; they never move to the CPU on
their own.
"""

__version__ = "0.1.0"

from ns_gls_tpu_torch.config import Parameters  # noqa: F401
