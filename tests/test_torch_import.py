"""The PyTorch port stands alone: importing it (and its driver) loads
neither JAX nor the JAX package, no port source names them, and its entry
points refuse to fall back to the CPU on their own."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax():
    # a fresh interpreter: this test process already imported jax
    code = (
        "import json, sys\n"
        "import ns_gls_tpu_torch, ns_gls_tpu_torch.driver\n"
        "import ns_gls_tpu_torch.__main__\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'ns_gls_tpu' "
        "or m.startswith('ns_gls_tpu.'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)|ns_gls_tpu\.", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "ns_gls_tpu_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    offenders = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                offenders.append(os.path.relpath(path, ROOT))
    assert offenders == []


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.device import resolve_device

    # decide "no card" here, whatever the machine has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = Parameters.from_file(os.path.join(ROOT, "input",
                                               "turek_2d_re100.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Driver(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert Driver(params, device="cpu").device == torch.device("cpu")


def test_unported_configuration_raises():
    from ns_gls_tpu_torch.config import Parameters
    from ns_gls_tpu_torch.driver import Driver

    for key, value in (("preconditioner", "AMG"),
                       ("nonlinear solver", "Picard"),
                       ("n devices", 2),
                       ("gmg coarse grid solver", "ILU")):
        params = Parameters.from_dict({"preconditioner": "GMG",
                                       "nonlinear solver": "Newton",
                                       "gmg coarse grid solver": "direct",
                                       key: value})
        with pytest.raises(NotImplementedError):
            Driver(params, device="cpu")
