"""The coarse solve's counters (``precond/gmg.py``, ``precond/amg.py``):
``coarse_gmres_it``, the GMRES iterations of the iterated coarse solve,
and ``amg_cycle``, one each AMG ``vmult``.

One driver step of ``input/sphere_amg.json`` at refinement 1, Q1 (its
coarsest level iso-Q1, solved by GMRES preconditioned with the AMG) on
the CPU: the step's record counts the iterations the coarse GMRES calls
returned and the AMG's applications, and the same step with the counters
switched off gives the same bits.  One step of ``input/channel.json`` at
refinement 0 with a coarse solve that is not iterated: no coarse GMRES
iterations, and one AMG cycle a coarse solve where the AMG is the coarse
solver, none where a dense LU is.
"""

import os

import pytest
import torch

from ns_gls_tpu_torch.config import Parameters, _load_json
from ns_gls_tpu_torch.driver import Driver
from ns_gls_tpu_torch.precond import amg, gmg
from ns_gls_tpu_torch.solvers import linear
from ns_gls_tpu_torch.utils.device import torch_threads
from ns_gls_tpu_torch.utils.logging import set_verbose


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


set_verbose(False)

INPUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "input")


def _step(name, overrides, patch=None):
    raw = _load_json(os.path.join(INPUT, name))
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    raw.update(overrides)
    drv = Driver(Parameters.from_dict(raw), device="cpu")
    drv.setup()
    drv._setup_done = True
    with pytest.MonkeyPatch.context() as mp:
        if patch is not None:
            patch(mp, drv)
        drv.run(max_steps=1)
    return drv


SPHERE = ("sphere_amg.json", {"n global refinements": 1, "fe degree": 1})


@pytest.fixture(scope="module")
def sphere():
    """The step, with the coarse GMRES calls' iterations and the AMG's
    applications counted by wrappers."""
    seen = {"coarse_its": 0, "coarse_calls": 0, "amg": 0}
    gmres, vmult = linear.gmres, amg.PreconditionerAMG.vmult

    def counted_gmres(A, b, x0, M=linear._identity, **kw):
        res = gmres(A, b, x0, M=M, **kw)
        if M == seen["drv"].preconditioner._coarse_apply:
            seen["coarse_its"] += res.iterations
            seen["coarse_calls"] += 1
        return res

    def counted_vmult(self, src):
        seen["amg"] += 1
        return vmult(self, src)

    def patch(mp, drv):
        seen["drv"] = drv
        mp.setattr(linear, "gmres", counted_gmres)
        mp.setattr(amg.PreconditionerAMG, "vmult", counted_vmult)

    return _step(*SPHERE, patch), seen


def test_sphere_coarse_gmres_iterations(sphere):
    drv, seen = sphere
    pc = drv.preconditioner
    assert pc.coarse_grid_iterate and pc.coarse_amg is not None
    st = drv.step_stats[-1]["counters"]
    assert seen["coarse_calls"] == st["vcycle"] > 0
    assert st["coarse_gmres_it"] == seen["coarse_its"] > st["vcycle"]


def test_sphere_amg_cycles(sphere):
    drv, seen = sphere
    st = drv.step_stats[-1]["counters"]
    assert st["amg_cycle"] == seen["amg"] >= st["coarse_gmres_it"]


def test_counters_leave_the_solution_bit_identical(sphere):
    drv, _ = sphere

    def silent(mp, _drv):
        mp.setattr(gmg, "count", lambda name, n=1: None)
        mp.setattr(amg, "count", lambda name, n=1: None)

    quiet = _step(*SPHERE, silent)
    assert quiet.step_stats[-1]["gmres"] == drv.step_stats[-1]["gmres"]
    assert torch.equal(quiet.solution.current, drv.solution.current)


@pytest.mark.parametrize("solver", ["direct", "AMG"])
def test_coarse_solve_not_iterated(solver):
    drv = _step("channel.json", {"n global refinements": 0,
                                 "gmg coarse grid iterate": False,
                                 "gmg coarse grid solver": solver})
    pc = drv.preconditioner
    st = drv.step_stats[-1]["counters"]
    assert (pc.coarse_lu is not None) == (solver == "direct")
    assert st["vcycle"] > 0 and st["coarse_gmres_it"] == 0
    assert st["amg_cycle"] == (st["vcycle"] if solver == "AMG" else 0)
