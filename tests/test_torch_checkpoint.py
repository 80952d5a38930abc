"""Checkpoints carry a run's state between the two packages and across a
restart of the port, on ``input/turek_2d_re100.json`` in Q1 at refinement
0 (BDF-2, f64 outer solve) on the CPU.

- A JAX run's state after 2 steps (its ``solution.vectors`` and
  ``time_integrator._dt``, stored by ``tools/solver_stack_series.py``),
  written here in the npz layout of the JAX package's checkpoints, is
  resumed by the port's ``Driver.run(resume=True)`` to step 4: within
  1e-10 of the max-abs of the JAX package's uninterrupted 4-step run.
- A port checkpoint after 2 steps is restored by the JAX package's
  ``load_checkpoint`` (``Driver.run(resume=True)`` of the JAX driver) and
  continued to step 4: within 1e-10 of the port's uninterrupted run
  (the two packages' uninterrupted runs differ by 2.0e-12).
- The port's own kill and resume: 2 steps checkpointing every step, then
  a fresh driver resumed to step 4, within 1e-12 (absolute) of 4
  uninterrupted steps, with the checkpoint counter and the cycle numbers
  the JAX driver would have.
"""

import gzip
import json
import os

import numpy as np
import pytest

from ns_gls_tpu_torch.config import Parameters
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.logging import set_verbose

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERIES = os.path.join(ROOT, "validation", "solver_stack_series.json.gz")
# smaller than any step: a checkpoint after every step
EVERY_STEP = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    set_verbose(False)
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def turek():
    with gzip.open(SERIES, "rt") as f:
        return json.load(f)["runs"]["turek_q1"]


@pytest.fixture(scope="module")
def uninterrupted(turek):
    """The port's 4 uninterrupted steps."""
    drv = Driver(Parameters.from_dict(turek["config"]), device="cpu")
    drv.run(max_steps=turek["steps"])
    return drv


def _cfg(turek, prefix):
    return dict(turek["config"], **{"checkpoint prefix": prefix,
                                    "checkpoint granularity": EVERY_STEP})


def _err(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def test_jax_state_resumed_by_port(turek, tmp_path):
    st = turek["state"]
    prefix = str(tmp_path / "jax_state")
    np.savez(prefix + ".npz", **{f"solution_{i}": np.asarray(v)
                                 for i, v in enumerate(st["vectors"])})
    with open(prefix + ".json", "w") as f:
        json.dump(dict(t=st["t"], counter=st["counter"],
                       dt_history=st["dt_history"],
                       n_vectors=len(st["vectors"])), f)
    drv = Driver(Parameters.from_dict(_cfg(turek, prefix)), device="cpu")
    drv.run(max_steps=turek["steps"], resume=True)
    assert len(drv.step_stats) == turek["steps"] - st["steps"]
    assert [s["newton"] for s in drv.step_stats] == \
        turek["nonlinear"][st["steps"]:]
    assert _err(drv.solution.current.numpy(), turek["solution"]) <= 1e-10


def test_port_checkpoint_restored_by_jax(turek, uninterrupted, tmp_path):
    from ns_gls_tpu.config import Parameters as JParameters
    from ns_gls_tpu.driver import Driver as JDriver
    import ns_gls_tpu.utils.logging as jlog

    jlog.set_verbose(False)
    prefix = str(tmp_path / "port")
    cfg = _cfg(turek, prefix)
    Driver(Parameters.from_dict(cfg), device="cpu").run(max_steps=2)
    jd = JDriver(JParameters.from_dict(cfg))
    jd.run(max_steps=turek["steps"], resume=True)
    assert _err(np.asarray(jd.solution.current),
                uninterrupted.solution.current.numpy()) <= 1e-10


def test_port_kill_and_resume(turek, uninterrupted, tmp_path):
    prefix = str(tmp_path / "port")
    cfg = Parameters.from_dict(_cfg(turek, prefix))
    first = Driver(cfg, device="cpu")
    first.run(max_steps=2)
    assert first._checkpoint_counter == 3          # saved after steps 1, 2
    with open(prefix + ".json") as f:
        meta = json.load(f)
    assert meta["counter"] == 3 and meta["n_vectors"] == 3
    assert meta["t"] == pytest.approx(first.time_reached, rel=1e-15)
    resumed = Driver(cfg, device="cpu")
    resumed.run(max_steps=turek["steps"], resume=True)
    assert resumed._checkpoint_counter == int(meta["t"] / EVERY_STEP) + 1 + 2
    assert len(resumed.step_stats) == 2
    assert resumed.time_reached == pytest.approx(
        uninterrupted.time_reached, rel=1e-14)
    diff = (resumed.solution.current - uninterrupted.solution.current).abs()
    assert float(diff.max()) <= 1e-12
