"""Parity of the PyTorch port's host and FE layer with the JAX package:
FE spaces (numbering, geometry, patch tiles), constraints, BDF weights and
MG transfers, on the same meshes built by each package's own code.

Tolerances: the space arrays come from copied numpy code and must be
EQUAL; constraint application and transfers are f64 gathers and sums
whose order may differ, so they hold to 1e-14 relative; BDF weights are
the same float formulas and hold to 1e-14.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ns_gls_tpu.driver as jdrv
import ns_gls_tpu.fem.constraints as jc
import ns_gls_tpu.fem.transfer as jt
import ns_gls_tpu_torch.driver as tdrv
import ns_gls_tpu_torch.fem.constraints as tc
import ns_gls_tpu_torch.fem.transfer as tt
from ns_gls_tpu.fem.space import FESpace as JSpace
from ns_gls_tpu.models.cylinder import SimulationCylinder as JCyl
from ns_gls_tpu.ops.time_integration import BDFIntegrator as JBDF
from ns_gls_tpu_torch.fem.space import FESpace as TSpace
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TCyl
from ns_gls_tpu_torch.ops.time_integration import BDFIntegrator as TBDF
from ns_gls_tpu_torch.utils.device import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores: one torch thread each."""
    with torch_threads(1):
        yield


TOL = 1e-14


def pin_point_locators(mp, locator):
    """Make both packages locate probe points alike, through ``mp`` (a
    pytest ``MonkeyPatch``): "native" tries the meshkit Q1 hit first,
    "numpy" the nearest cell centres only.  On a point that lies on a face
    the two can pick different cells (ROADMAP queue 3).  The JAX package
    builds ``native/libmeshkit.so`` with its own ``make`` at first use,
    unlocked, and caches a failed load: a process that found the file
    half-written is reset here and retried, for at most 120 s, until the
    complete library loads."""
    import ns_gls_tpu.utils.native as jn
    import ns_gls_tpu_torch.utils.native as tn

    if locator == "numpy":
        mp.setattr(jn, "_TRIED", True)
        mp.setattr(jn, "_LIB", None)
        mp.setattr(tn, "_lib", lambda: None)
        return
    assert tn._lib() is not None
    deadline = time.monotonic() + 120.0
    while True:
        try:
            if jn._lib() is not None:
                return
        except AttributeError:      # a partial file without the symbols
            pass
        if time.monotonic() > deadline:
            raise AssertionError("the JAX package's native/libmeshkit.so "
                                 "did not load in 120 s")
        time.sleep(0.5)
        mp.setattr(jn, "_TRIED", False)
        mp.setattr(jn, "_LIB", None)


def _meshes(which):
    """(JAX mesh, port mesh) built by each package's own generators."""
    out = []
    for pkg in ("ns_gls_tpu", "ns_gls_tpu_torch"):
        cyl = __import__(f"{pkg}.mesh.cylinder", fromlist=["x"])
        gen = __import__(f"{pkg}.mesh.generators", fromlist=["x"])
        if which.startswith("turek3d"):    # the extruded Turek 3D mesh
            mod = __import__(f"{pkg}.models.cylinder", fromlist=["x"])
            m = mod.SimulationCylinder(3).create_mesh(int(which[-1]))
        elif which.startswith("turek"):
            m = cyl.cylinder_mesh_2d()
            for _ in range(int(which[-1])):
                m = m.refine()
        else:                      # multiblock: the patch-2D test mesh
            m = gen.subdivided_hyper_rectangle((3, 2), (0.0, 0.0),
                                               (1.1, 0.9))
            m.lattice = None
            for _ in range(2):
                m = m.refine()
        out.append(m)
    return out


def _spaces(which, degree=2):
    mj, mt = _meshes(which)
    return JSpace(mj, degree), TSpace(mt, degree)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _close(a, ref):
    """|a - ref| <= TOL * max(|ref|, 1) (arrays that may be all zero)."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(a - ref).max(initial=0.0) <= TOL * max(
        np.abs(ref).max(initial=0.0), 1.0)


@pytest.mark.parametrize("which", ["turek1", "turek2", "multiblock"])
def test_space_arrays_equal(which):
    sj, st = _spaces(which)
    assert st.patch2d and sj.patch2d
    assert st.n_nodes == sj.n_nodes and st.n2d == sj.n2d
    for name in ("node_pos", "cell_nodes", "jinv", "jxw",
                 "cell_h_min_vertex", "cell_measure", "node_gather_perm"):
        assert np.array_equal(getattr(st, name), getattr(sj, name)), name
    assert len(st.patch2d_families) == len(sj.patch2d_families) == 1
    fj, ft = sj.patch2d_families[0], st.patch2d_families[0]
    assert fj["m"] == ft["m"]
    for key in ("cells", "patch_of_cell", "lattice_of_cell", "patch_nodes"):
        assert np.array_equal(ft[key], fj[key]), key
    for (a0, k0, i0), (a1, k1, i1) in zip(st.node_gather_classes,
                                          sj.node_gather_classes):
        assert a0 == a1 and k0 == k1 and np.array_equal(i0, i1)


@pytest.mark.parametrize("which", ["turek1", "turek2"])
def test_turek_constraint_sets(which):
    """The driver's three constraint sets (Dirichlet walls, cylinder and
    inflow, the positional pressure pin) and their application."""
    sj, st = _spaces(which)
    bj = JCyl(2).get_boundary_descriptor()
    bt = TCyl(2).get_boundary_descriptor()
    cj = jdrv.ConstraintSetBuilder(sj, bj, jnp.float64)
    ct = tdrv.ConstraintSetBuilder(st, bt, torch.float64, "cpu")
    t_eval = 0.004
    for a, b in ((cj.full, ct.full), (cj.homogeneous, ct.homogeneous),
                 (cj.inhomogeneous_at(t_eval), ct.inhomogeneous_at(t_eval))):
        assert np.array_equal(np.asarray(a.rows), b.rows.numpy())
        assert np.array_equal(np.asarray(a.cols), b.cols.numpy())
        assert _close(b.weights.numpy(), a.weights)
        assert _close(b.inhom.numpy(), a.inhom)
    _check_apply(cj.inhomogeneous_at(t_eval), ct.inhomogeneous_at(t_eval),
                 st.n_nodes)


def _check_apply(ca_j, ca_t, n_nodes):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((n_nodes, 3))
    v = rng.standard_normal((n_nodes, 3))
    uj, ut = jnp.asarray(u), torch.as_tensor(u)
    vj, vt = jnp.asarray(v), torch.as_tensor(v)
    pairs = [
        (jc.distribute(ca_j, uj), tc.distribute(ca_t, ut)),
        (jc.distribute(ca_j, uj, homogeneous=True),
         tc.distribute(ca_t, ut, homogeneous=True)),
        (jc.set_zero(ca_j, uj), tc.set_zero(ca_t, ut)),
        (jc.condense_transpose(ca_j, uj), tc.condense_transpose(ca_t, ut)),
        (jc.copy_constrained(ca_j, uj, vj), tc.copy_constrained(ca_t, ut, vt)),
    ]
    for a, b in pairs:
        assert _rel(b.numpy(), a) <= TOL
    # the port's functions leave their arguments unchanged
    assert np.array_equal(ut.numpy(), u) and np.array_equal(vt.numpy(), v)


def test_hanging_slip_periodic_constraints():
    """Chains through hanging nodes, slip and periodic lines on an
    adaptively refined mesh (hanging nodes on the refinement edge)."""
    from ns_gls_tpu.fem.hanging import hanging_node_constraints as jhang
    from ns_gls_tpu_torch.fem.hanging import hanging_node_constraints as thang

    out = []
    for pkg, Space, hang in (("ns_gls_tpu", JSpace, jhang),
                             ("ns_gls_tpu_torch", TSpace, thang)):
        gen = __import__(f"{pkg}.mesh.generators", fromlist=["x"])
        m = gen.subdivided_hyper_rectangle((3, 2), (0.0, 0.0), (1.1, 0.9))
        m.lattice = None
        m = m.refine_global(1)
        c = m.vertices[m.cells].mean(1)
        m = m.refine(c[:, 0] < 0.5)
        sp = Space(m, 2)
        cons = __import__(f"{pkg}.fem.constraints", fromlist=["x"])
        b = cons.AffineConstraints(sp.n_nodes, 3)
        b.add_dirichlet(sp.boundary_nodes([0]), [0, 1],
                        values=[[1.0, 0.5]] * len(sp.boundary_nodes([0])))
        nodes, normals = sp.boundary_node_normals([2])
        b.add_no_normal_flux(nodes, normals)
        na, nb = sp.boundary_nodes([1]), sp.boundary_nodes([0])
        ya = np.round(sp.node_pos[na][:, 1], 9)
        yb = {y: n for y, n in zip(np.round(sp.node_pos[nb][:, 1], 9), nb)}
        b.add_periodic([a for a, y in zip(na, ya) if y in yb],
                       [yb[y] for y in ya if y in yb], [2])
        hanging = hang(sp)
        assert hanging
        for node, masters, weights in hanging:
            b.add_hanging_node(node, None, masters, weights)
        out.append((sp, b))
    (sj, bj), (st, bt) = out
    ca_j = bj.close(jnp.float64)
    ca_t = bt.close(torch.float64, "cpu")
    assert np.array_equal(np.asarray(ca_j.rows), ca_t.rows.numpy())
    assert np.array_equal(np.asarray(ca_j.cols), ca_t.cols.numpy())
    assert _rel(ca_t.weights.numpy(), ca_j.weights) <= TOL
    _check_apply(ca_j, ca_t, st.n_nodes)


def test_bdf_weights_variable_dt():
    dts = [0.03, 0.021, 0.026, 0.0193, 0.024, 0.031]
    for order in (1, 2, 3):
        ij, it = JBDF(order), TBDF(order)
        for dt in dts:
            ij.update_dt(dt)
            it.update_dt(dt)
            assert np.abs(np.subtract(it.weights, ij.weights)).max() <= (
                TOL * np.abs(ij.weights).max())
            assert it.current_dt == ij.current_dt


@pytest.mark.parametrize("which", ["turek3d0", "turek3d1"])
def test_prism_space_arrays_equal(which):
    """The Turek 3D spaces: product (node2d, z) numbering, geometry and
    the prism patch tables of both packages are equal."""
    sj, st = _spaces(which)
    assert st.prism and sj.prism
    assert (st.n_nodes, st.n2d, st.nz_nodes, st.nz_cells, st.patch_cells) \
        == (sj.n_nodes, sj.n2d, sj.nz_nodes, sj.nz_cells, sj.patch_cells)
    for name in ("node_pos", "cell_nodes", "jinv", "jxw",
                 "cell_h_min_vertex", "cell_measure", "patch_nodes",
                 "patch_of_cell2d", "lattice_of_cell2d", "node2d_mult"):
        assert np.array_equal(np.asarray(getattr(st, name)),
                              np.asarray(getattr(sj, name))), name


@pytest.mark.parametrize("locator", ["native", "numpy"])
def test_cylinder_3d_functionals(locator, monkeypatch):
    """Drag and lift (the 3D normalization 2 / (D u_bar^2 H)) and the
    pressure-drop probes of the Turek 3D model on one random solution,
    with both packages on the same point locator: on different ones the
    probes land in different cells and p_diff differs by 1.8e-10
    relative (``test_port_locators_on_turek3d_probes``)."""
    from ns_gls_tpu.models.cylinder import SimulationCylinder as JC
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TC

    pin_point_locators(monkeypatch, locator)
    sj, st = _spaces("turek3d0")
    simj, simt = JC(3), TC(3)
    simj.setup_postprocess(sj, 0.001)
    simt.setup_postprocess(st, 0.001, "cpu")
    assert simt._scaling == pytest.approx(simj._scaling, rel=1e-15)
    u = np.random.default_rng(4).standard_normal((st.n_nodes, 4))
    rj = simj.postprocess(0.1, jnp.asarray(u))
    rt = simt.postprocess(0.1, torch.as_tensor(u))
    for k in ("drag", "lift", "p_diff"):
        assert rt[k] == pytest.approx(rj[k], rel=1e-12, abs=1e-12), k


def test_port_locators_on_turek3d_probes(monkeypatch):
    """The port's native and numpy point locators on the Turek 3D ref-0
    pressure probes (-D/2, 0, 0) and (D/2, 0, 0), Q2.  Each locator maps
    its reference point to within the Newton tolerance (1e-8) of the
    probe; where the two pick the same cell, the reference points are
    equal.  Both probes lie on faces between cells, and there the two
    pick different cells (103 and 204 for the first, 100 and 107 for the
    second): the images lie 2.4e-11 from the probe, and the pressure
    difference of a unit random Q2 field differs by 3.9e-10 (1.8e-10
    relative), a gap the field's continuity bounds by its gradient times
    the distance between the images."""
    from ns_gls_tpu_torch.fem.element import tabulate_at
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TC
    from ns_gls_tpu_torch.utils import native, point_eval

    sim = TC(3)
    space = TSpace(sim.create_mesh(0), 2)
    probes = np.zeros((2, 3))
    probes[:, 0] = [-0.5, 0.5]
    probes *= sim.geometry_cylinder_diameter
    assert native._lib() is not None
    located = {"native": point_eval.locate_points(space, probes)}
    monkeypatch.setattr(native, "_lib", lambda: None)
    located["numpy"] = point_eval.locate_points(space, probes)
    u = np.random.default_rng(4).standard_normal((space.n_nodes, 4))

    def at(cells, refs):
        """Images of the reference points, and u there."""
        x, v = [], []
        for c, r in zip(cells, refs):
            x.append(tabulate_at(space.mapping_degree, 3, r[None])[0][0]
                     @ space.map_points[c])
            v.append(tabulate_at(space.degree, 3, r[None])[0][0]
                     @ u[space.cell_nodes[c]])
        return np.array(x), np.array(v)

    (cn, rn), (cp, rp) = located["native"], located["numpy"]
    xn, vn = at(cn, rn)
    xp, vp = at(cp, rp)
    assert np.abs(xn - probes).max() < 1e-8
    assert np.abs(xp - probes).max() < 1e-8
    same = cn == cp
    assert np.array_equal(rn[same], rp[same])
    assert cn.tolist() == [103, 100] and cp.tolist() == [204, 107]
    assert np.abs(xn - xp).max() < 1e-10
    p_diff = (vn[0, 3] - vn[1, 3], vp[0, 3] - vp[1, 3])
    gap = abs(p_diff[0] - p_diff[1])
    assert 0.0 < gap < 1e-9, gap


def _vtu_arrays(path):
    """The binary DataArrays of a VTU file by name (points: "Points")."""
    import base64
    import struct
    import xml.etree.ElementTree as ET

    types = {"Float64": np.float64, "Int64": np.int64, "UInt8": np.uint8}
    out = {}
    root = ET.parse(path).getroot()
    for parent in root.iter():
        for da in parent.findall("DataArray"):
            if da.get("format") != "binary":
                continue
            raw = base64.b64decode(da.text)
            n = struct.unpack("<I", raw[:4])[0]
            name = da.get("Name") or parent.tag
            out[name] = np.frombuffer(raw[4:4 + n], types[da.get("type")])
    return out


def test_cylinder_3d_slices(tmp_path):
    """The two 3D slice files (z = 0 midplane, cross-section through the
    cylinder axis) of the Turek 3D model at refinement 0, written by both
    packages from one random solution: the same cells, points and values
    to round-off."""
    from ns_gls_tpu.models.cylinder import SimulationCylinder as JC
    from ns_gls_tpu_torch.models.cylinder import SimulationCylinder as TC

    sj, st = _spaces("turek3d0")
    sims = {}
    for name, sim, space in (("jax", JC(3), sj), ("torch", TC(3), st)):
        sim.paraview_prefix = str(tmp_path / name)
        sim.output_granularity = 0.1
        sims[name] = (sim, space)
    sims["jax"][0].setup_postprocess(sj, 0.001)
    sims["torch"][0].setup_postprocess(st, 0.001, "cpu")
    u = np.random.default_rng(5).standard_normal((st.n_nodes, 4))
    sims["jax"][0].postprocess(0.0, jnp.asarray(u))
    sims["torch"][0].postprocess(0.0, torch.as_tensor(u))
    for c in (0, 1):
        aj = _vtu_arrays(tmp_path / f"jax_slice_{c}_0.vtu")
        at = _vtu_arrays(tmp_path / f"torch_slice_{c}_0.vtu")
        assert set(at) == set(aj) == {"Points", "connectivity", "offsets",
                                      "types", "u", "p"}
        for k in ("connectivity", "offsets", "types"):
            assert np.array_equal(at[k], aj[k]), (c, k)
        for k in ("Points", "u", "p"):
            assert _close(at[k], aj[k]), (c, k)
        assert np.abs(aj["u"]).max() > 0.0     # the slice found its cells


@pytest.mark.parametrize("which", ["turek1", "multiblock", "turek3d1"])
def test_transfers(which):
    mj, mt = _meshes(which)
    cj, ct = JSpace(mj.prev, 2), TSpace(mt.prev, 2)
    fj, ft = JSpace(mj, 2), TSpace(mt, 2)
    tj = jt.build_transfer(cj, fj, jnp.float64)
    ttr = tt.build_transfer(ct, ft, torch.float64, "cpu")
    assert np.array_equal(np.asarray(tj.p_cols), ttr.p_cols.numpy())
    assert np.array_equal(np.asarray(tj.i_cols), ttr.i_cols.numpy())
    assert np.array_equal(np.asarray(tj.p_wts), ttr.p_wts.numpy())
    assert np.array_equal(np.asarray(tj.i_wts), ttr.i_wts.numpy())
    rng = np.random.default_rng(1)
    C = ft.dim + 1
    uc = rng.standard_normal((ct.n_nodes, C))
    uf = rng.standard_normal((ft.n_nodes, C))
    for a, b in (
        (jt.prolongate(tj, jnp.asarray(uc)), tt.prolongate(ttr, torch.as_tensor(uc))),
        (jt.restrict(tj, jnp.asarray(uf)), tt.restrict(ttr, torch.as_tensor(uf))),
        (jt.interpolate_to_coarse(tj, jnp.asarray(uf)),
         tt.interpolate_to_coarse(ttr, torch.as_tensor(uf))),
    ):
        assert _rel(b.numpy(), a) <= TOL
