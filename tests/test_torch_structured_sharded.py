"""The port's slab-sharded structured operator
(``ns_gls_tpu_torch/parallel/structured_sharded.py``) against the JAX
package's (``ns_gls_tpu/parallel/structured_sharded.py``, the model of
this file: ``tests/test_structured_sharded.py``), the JAX operator on n of
the 8 virtual CPU devices of ``tests/conftest.py``, the port's on
``["cpu"] * n``.

- The sharded apply equals JAX's sharded apply and the port's own
  one-device sweep within 1e-5 relative to the reference's max-abs (f32
  on both sides, in different summation orders; the JAX shards run the
  Pallas structured kernel in interpret mode).
- One apply moves two class-0 planes per neighbour pair; the masked dot
  equals the global dot within 1e-6 relative; scatter then gather is the
  identity; a slab count the shards do not divide raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ns_gls_tpu.fem.constraints import AffineConstraints as JAff
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.mesh import generators as jgen
from ns_gls_tpu.ops.navier_stokes import NavierStokesOperator as JOp
from ns_gls_tpu.ops.time_integration import (
    BDFIntegrator as JBDF,
    SolutionHistory as JHist,
)
from ns_gls_tpu.parallel.structured_sharded import (
    StructuredShardedOperator as JSharded,
)
from ns_gls_tpu_torch.fem.constraints import AffineConstraints as TAff
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.mesh import generators as tgen
from ns_gls_tpu_torch.ops.navier_stokes import NavierStokesOperator as TOp
from ns_gls_tpu_torch.ops.structured import StructuredSweep, structured_sweep
from ns_gls_tpu_torch.ops.time_integration import (
    BDFIntegrator as TBDF,
    SolutionHistory as THist,
)
from ns_gls_tpu_torch.parallel.structured_sharded import (
    StructuredShardedOperator,
)
from ns_gls_tpu_torch.utils.device import torch_threads

TOL = 1e-5
DOT_TOL = 1e-6
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


def _mesh(gen, dim, n_last=8):
    shape = (3, n_last) if dim == 2 else (2, 2, n_last)
    ext = (1.2, 2.0) if dim == 2 else (0.8, 0.9, 2.0)
    return gen.subdivided_hyper_rectangle(shape, (0.0,) * dim, ext,
                                          colorize=True)


def make_ops(dim, degree, n_last=8):
    """The JAX and the port's f32 structured operators of the JAX test
    (BDF-2, q-wise delta), with one state from numpy seed 0 (u, 0.9 u,
    0.8 u)."""
    kw = dict(nu=0.02, c_1=4.0, c_2=2.0, consider_time_derivative=True,
              increment_form=False, cell_wise_stabilization=False)
    sj = JSpace(_mesh(jgen, dim, n_last), degree)
    st = TSpace(_mesh(tgen, dim, n_last), degree)
    C = dim + 1
    caj = JAff(sj.n_nodes, C).close(jnp.float32)
    cat = TAff(st.n_nodes, C).close(F32, "cpu")
    tij, tit = JBDF(2), TBDF(2)
    for dt in (0.1, 0.08):
        tij.update_dt(dt)
        tit.update_dt(dt)
    opj = JOp(sj, caj, caj, time_integrator=tij, fuse_tables=True,
              dtype=jnp.float32, use_structured=True, **kw)
    opt = TOp(st, cat, cat, time_integrator=tit, dtype=F32, device="cpu",
              **kw)
    assert isinstance(opt._fast, StructuredSweep)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((st.n_nodes, C)).astype(np.float32)
    hist = [u, u * np.float32(0.9), u * np.float32(0.8)]
    opj.constraints_inhomogeneous = caj
    opj.set_previous_solution(JHist([jnp.asarray(h) for h in hist]))
    opj.set_linearization_point(jnp.asarray(u))
    opt.constraints_inhomogeneous = cat
    opt.set_previous_solution(THist.from_numpy(hist, F32, "cpu"))
    opt.set_linearization_point(torch.as_tensor(u))
    return opj, opt, u


def _port_args(opt, u):
    C = opt.n_comp
    uT = torch.as_tensor(u).T.contiguous().reshape(
        (C,) + opt._fast.lattice_shape)
    st = opt.state
    return (opt._weight_host, opt._stau_host, uT, st.u_linT.contiguous(),
            st.vec_oldT.contiguous())


def _close(a, ref, tol=TOL):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(a - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("dim,degree,flavor", [
    (2, 1, "fixed"), (2, 2, "residual"), (3, 1, "fixed"),
    (3, 2, "increment")])
def test_sharded_apply_matches_jax_and_one_device(dim, degree, flavor,
                                                  n_dev):
    opj, opt, u = make_ops(dim, degree)
    weight, stau, uT, ulT, voT = _port_args(opt, u)
    sw = opt._fast
    one = structured_sweep(sw.tables, dict(weight=weight, stau=stau,
                                           nu=sw.nu, c1=sw.c1, c2=sw.c2),
                           uT, ulT, voT, flavor, sw.consider_dt,
                           sw.cell_wise)
    sop = StructuredShardedOperator(opt, ["cpu"] * n_dev)
    got = sop.gather_global(sop.apply(weight, stau, sop.scatter(uT),
                                      sop.scatter(ulT), sop.scatter(voT),
                                      flavor))
    _close(got.numpy(), one.numpy())

    st = opj.state
    jop = JSharded(opj, Mesh(np.array(jax.devices()[:n_dev]), ("z",)))
    ujT = jnp.asarray(u).T.reshape((dim + 1,) + opj._ssweep.lattice_shape)
    ref = jop.gather_global(jop.apply(st.weight, st.stau, jop.scatter(ujT),
                                      jop.scatter(st.u_linT),
                                      jop.scatter(st.vec_oldT), flavor))
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_exchange_dot_and_layout(dim):
    opj, opt, u = make_ops(dim, 2)
    weight, stau, uT, ulT, voT = _port_args(opt, u)
    n_dev = 4
    sop = StructuredShardedOperator(opt, ["cpu"] * n_dev)
    # scatter -> gather round-trips exactly
    parts = sop.scatter(uT)
    assert torch.equal(sop.gather_global(parts), uT)
    assert [tuple(p.shape) for p in parts] == \
        [(dim + 1, sop.m_pl, sop.Yr, sop.Nx)] * n_dev
    # one apply moves two class-0 planes per neighbour pair
    sop.elements_moved = 0
    out = sop.apply(weight, stau, parts, sop.scatter(ulT), sop.scatter(voT),
                    "fixed")
    plane = (dim + 1) * sop.Yr * sop.Nx
    assert sop.elements_moved == sop.exchange_elements \
        == 2 * (n_dev - 1) * plane
    # the masked dot counts each shared plane once
    ref = sop.gather_global(out)
    want = float((ref.double() ** 2).sum())
    got = float(sop.dot(sop.scatter(ref), sop.scatter(ref)))
    assert abs(got - want) <= DOT_TOL * abs(want)
    # slab counts the shards do not divide raise
    with pytest.raises(ValueError, match="not divisible"):
        StructuredShardedOperator(opt, ["cpu"] * 3)
