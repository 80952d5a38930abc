"""Frozen copy of ``ns_gls_tpu_torch/mesh/cylinder.py``, taken when the
benchmark was defined, so that the reference works out its geometry
without the program. Changed: imports point at this folder; the parts
the reference does not use are left out.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.frozen.core import CylindricalManifold, Mesh, PolarManifold
from benchmark.reference.frozen.generators import (
    extrude,
    hyper_cube_with_cylindrical_hole,
    merge_triangulations,
    subdivided_hyper_rectangle,
    transform,
)


def cylinder_mesh_2d(
    length: float = 2.2,
    height: float = 0.41,
    cylinder_position: float = 0.2,
    cylinder_diameter: float = 0.1,
    shift: float = 0.005,
    for_3d: bool = False,
) -> Mesh:
    """2D Turek cylinder channel (reference ``grid_cylinder.h:7-151``)."""
    D = cylinder_diameter

    patches = [
        # center: square with hole
        hyper_cube_with_cylindrical_hole(D / 2.0, D),
        # below / above the center square
        subdivided_hyper_rectangle((2, 1), (-D, -height / 2.0 + shift), (D, -D)),
        subdivided_hyper_rectangle((2, 1), (-D, D), (D, height / 2.0 + shift)),
        # right block
        subdivided_hyper_rectangle(
            (18, 2), (D, -D), (length - cylinder_position, D)
        ),
        subdivided_hyper_rectangle(
            (18, 1), (D, D), (length - cylinder_position, height / 2.0 + shift)
        ),
        subdivided_hyper_rectangle(
            (18, 1), (D, -height / 2.0 + shift), (length - cylinder_position, -D)
        ),
        # left block
        subdivided_hyper_rectangle(
            (4 if for_3d else 1, 2), (-cylinder_position, -D), (-D, D)
        ),
        subdivided_hyper_rectangle(
            (4 if for_3d else 1, 1), (-cylinder_position, D),
            (-D, height / 2.0 + shift),
        ),
        subdivided_hyper_rectangle(
            (4 if for_3d else 1, 1), (-cylinder_position, -height / 2.0 + shift),
            (-D, -D),
        ),
    ]
    # NOTE: reference swaps the second rectangle's y-extent sign layout;
    # ours is (low, high) ordered already.
    mesh = merge_triangulations(patches, tol=1e-9)
    mesh.manifolds[0] = PolarManifold((0.0, 0.0))

    def ids(centers):
        out = np.full(len(centers), 2, dtype=np.int32)  # default: cylinder
        out[centers[:, 0] > length - cylinder_position - 1e-6] = 1  # outflow
        out[centers[:, 0] < -cylinder_position + 1e-6] = 0          # inflow
        out[np.abs(centers[:, 1] - (height / 2.0 + shift)) < 1e-6] = 4   # top
        out[np.abs(centers[:, 1] - (-height / 2.0 + shift)) < 1e-6] = 3  # bottom
        return out

    mesh.set_boundary_ids(ids)
    return mesh


def cylinder_mesh_3d(
    length: float = 2.5,
    height: float = 0.41,
    cylinder_position: float = 0.5,
    cylinder_diameter: float = 0.1,
    shift: float = 0.005,
) -> Mesh:
    """3D Turek cylinder channel: 2D mesh extruded over 5 z-slices and
    re-centered (reference ``grid_cylinder.h:153-242``)."""
    m2 = cylinder_mesh_2d(
        length, height, cylinder_position, cylinder_diameter, shift, for_3d=True
    )
    mesh = extrude(m2, 5, height)
    mesh = transform(mesh, lambda v: v - np.array([0.0, 0.0, height / 2.0]))
    mesh.manifolds[0] = CylindricalManifold((0.0, 0.0, 0.0))

    def ids(centers):
        out = np.full(len(centers), 2, dtype=np.int32)
        out[centers[:, 0] > length - cylinder_position - 1e-6] = 1
        out[centers[:, 0] < -cylinder_position + 1e-6] = 0
        out[np.abs(centers[:, 1] - (height / 2.0 + shift)) < 1e-6] = 4
        out[np.abs(centers[:, 1] - (-height / 2.0 + shift)) < 1e-6] = 3
        out[np.abs(centers[:, 2] - height / 2.0) < 1e-6] = 6
        out[np.abs(centers[:, 2] + height / 2.0) < 1e-6] = 5
        return out

    mesh.set_boundary_ids(ids)
    return mesh
