"""VTU (VTK XML unstructured grid) writer with Lagrange higher-order cells.

Equivalent of the reference's parallel VTU output with
``write_higher_order_cells`` (``main.cc:1024-1048``): one
VTK_LAGRANGE_QUADRILATERAL / _HEXAHEDRON cell per mesh cell, velocity as a
vector field + pressure scalar.
"""

from __future__ import annotations

import base64
import struct

import numpy as np


def _vtk_lagrange_order(degree: int, dim: int) -> np.ndarray:
    """Permutation lexicographic -> VTK Lagrange node ordering."""
    n1 = degree + 1
    if dim == 2:
        idx = np.arange(n1 * n1).reshape(n1, n1)  # [iy, ix] if C-order...
        # our lexicographic: node = ix + n1*iy -> arr[iy, ix]
        lex = lambda ix, iy: ix + n1 * iy
        order = []
        # corners
        order += [lex(0, 0), lex(degree, 0), lex(degree, degree), lex(0, degree)]
        # edges: bottom, right, top, left (interior nodes, ascending)
        order += [lex(i, 0) for i in range(1, degree)]
        order += [lex(degree, i) for i in range(1, degree)]
        order += [lex(i, degree) for i in range(1, degree)]
        order += [lex(0, i) for i in range(1, degree)]
        # interior (lexicographic)
        for j in range(1, degree):
            for i in range(1, degree):
                order.append(lex(i, j))
        return np.array(order)
    lex = lambda ix, iy, iz: ix + n1 * (iy + n1 * iz)
    d = degree
    order = [
        lex(0, 0, 0), lex(d, 0, 0), lex(d, d, 0), lex(0, d, 0),
        lex(0, 0, d), lex(d, 0, d), lex(d, d, d), lex(0, d, d),
    ]
    rng = range(1, d)
    # 12 edges, VTK order
    order += [lex(i, 0, 0) for i in rng]
    order += [lex(d, i, 0) for i in rng]
    order += [lex(i, d, 0) for i in rng]
    order += [lex(0, i, 0) for i in rng]
    order += [lex(i, 0, d) for i in rng]
    order += [lex(d, i, d) for i in rng]
    order += [lex(i, d, d) for i in rng]
    order += [lex(0, i, d) for i in rng]
    order += [lex(0, 0, i) for i in rng]
    order += [lex(d, 0, i) for i in rng]
    order += [lex(d, d, i) for i in rng]
    order += [lex(0, d, i) for i in rng]
    # 6 faces (VTK: x-,x+,y-,y+,z-,z+), row-major in the face params
    for j in rng:
        for i in rng:
            order.append(lex(0, i, j))
    for j in rng:
        for i in rng:
            order.append(lex(d, i, j))
    for j in rng:
        for i in rng:
            order.append(lex(i, 0, j))
    for j in rng:
        for i in rng:
            order.append(lex(i, d, j))
    for j in rng:
        for i in rng:
            order.append(lex(i, j, 0))
    for j in rng:
        for i in rng:
            order.append(lex(i, j, d))
    # interior
    for k in rng:
        for j in rng:
            for i in rng:
                order.append(lex(i, j, k))
    return np.array(order)


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode()


def write_vtu(file_name: str, space, solution: np.ndarray, time: float = None,
              points: np.ndarray = None, n_comp: int = None):
    """solution: (n_nodes, n_comp) -> fields 'u' (vector) and 'p'.

    `points` optionally overrides node positions (e.g. a 2D patch space
    embedded in 3D for slice outputs); `n_comp` overrides dim+1 when the
    data dimensionality differs from the mesh dimensionality."""
    dim = space.dim
    vdim = (n_comp - 1) if n_comp else dim
    degree = space.degree
    perm = _vtk_lagrange_order(degree, dim)
    n_c = space.mesh.n_cells
    n_loc = space.element.n_loc

    pts = space.node_pos if points is None else np.asarray(points)
    if pts.shape[1] == 2:
        pts = np.hstack([pts, np.zeros((len(pts), 1))])
    conn = space.cell_nodes[:, perm].astype(np.int64).reshape(-1)
    offsets = (np.arange(n_c, dtype=np.int64) + 1) * n_loc
    ctype = 70 if dim == 2 else 72  # VTK_LAGRANGE_QUAD / _HEXAHEDRON
    types = np.full(n_c, ctype, dtype=np.uint8)

    u = solution[:, :vdim].astype(np.float64)
    if vdim == 2:
        u = np.hstack([u, np.zeros((len(u), 1))])
    p = solution[:, vdim].astype(np.float64)

    with open(file_name, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n'
        )
        f.write("<UnstructuredGrid>\n")
        if time is not None:
            f.write(
                '<FieldData><DataArray type="Float64" Name="TimeValue" '
                f'NumberOfTuples="1" format="ascii">{time}</DataArray>'
                "</FieldData>\n"
            )
        f.write(
            f'<Piece NumberOfPoints="{len(pts)}" NumberOfCells="{n_c}">\n'
        )
        f.write("<Points>\n")
        f.write(
            '<DataArray type="Float64" NumberOfComponents="3" '
            f'format="binary">{_b64(pts.astype(np.float64))}</DataArray>\n'
        )
        f.write("</Points>\n<Cells>\n")
        f.write(
            '<DataArray type="Int64" Name="connectivity" format="binary">'
            f"{_b64(conn)}</DataArray>\n"
        )
        f.write(
            '<DataArray type="Int64" Name="offsets" format="binary">'
            f"{_b64(offsets)}</DataArray>\n"
        )
        f.write(
            '<DataArray type="UInt8" Name="types" format="binary">'
            f"{_b64(types)}</DataArray>\n"
        )
        f.write("</Cells>\n")
        f.write('<PointData Vectors="u">\n')
        f.write(
            '<DataArray type="Float64" Name="u" NumberOfComponents="3" '
            f'format="binary">{_b64(u)}</DataArray>\n'
        )
        f.write(
            '<DataArray type="Float64" Name="p" format="binary">'
            f"{_b64(p)}</DataArray>\n"
        )
        f.write("</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")
