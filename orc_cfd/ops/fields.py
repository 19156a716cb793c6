"""Boundary-condition arrays on device.

`BoundaryTable` (host) -> small per-zone device arrays -> per-face
gathered arrays used by every interpolation/assembly op. BC *values* are
traced data, so editing them never recompiles; BC *types* are also traced
(selected with `jnp.where` masks), so even retyping a zone reuses the
same executable.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.mesh.zones import BoundaryTable, FaceCondition
from orc_cfd.ops.layout import take

# Integer codes used in on-device selects.
INTERIOR = int(FaceCondition.INTERIOR)
WALL = int(FaceCondition.WALL)
PRESSURE_INLET = int(FaceCondition.PRESSURE_INLET)
PRESSURE_OUTLET = int(FaceCondition.PRESSURE_OUTLET)
SYMMETRY = int(FaceCondition.SYMMETRY)
VELOCITY_INLET = int(FaceCondition.VELOCITY_INLET)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FaceBC:
    """Per-face boundary-condition data (gathered from the zone table).

    The tiny per-zone tables are kept alongside the per-face arrays:
    (c,k)-shaped consumers must gather BC data zone-table -> [C,K]
    directly (`ck()`), NOT through the per-face arrays — a gather of an
    in-graph-produced [F,3] array can materialize minor-dim-padded
    buffers (see ops/layout.py)."""

    code: jax.Array  # [F] i32 FaceCondition code
    scalar: jax.Array  # [F] zone scalar (boundary pressure, ...)
    vector: jax.Array  # [F,3] zone vector (wall/inlet velocity, ...)
    zcode: jax.Array  # [Z] i32 zone table
    zscalar: jax.Array  # [Z]
    zvector: jax.Array  # [Z,3]

    def is_(self, *codes: int) -> jax.Array:
        m = self.code == codes[0]
        for c in codes[1:]:
            m = m | (self.code == c)
        return m

    def ck(self, mesh: "CompiledMesh"):
        """(code, scalar, vector) per (cell, face-slot): [C,K], [C,K],
        [C,K,3], selected from the zone tables with a static Z-way
        `where` chain over the face zone slot (gathers indexed by
        in-graph [C,K] arrays can materialize padded buffers)."""
        zs = take(mesh.face_zone_slot, mesh.cell_faces)
        Z = self.zcode.shape[0]
        code = jnp.full(zs.shape, self.zcode[0], self.zcode.dtype)
        scalar = jnp.full(zs.shape, self.zscalar[0], self.zscalar.dtype)
        vector = jnp.broadcast_to(self.zvector[0], zs.shape + (3,))
        for z in range(1, Z):
            sel = zs == z
            code = jnp.where(sel, self.zcode[z], code)
            scalar = jnp.where(sel, self.zscalar[z], scalar)
            vector = jnp.where(sel[..., None], self.zvector[z], vector)
        return code, scalar, vector


def device_bc(table: BoundaryTable, dtype=jnp.float64):
    """Zone-level device arrays: (codes[Z] i32, scalar[Z], vector[Z,3])."""
    return (
        jnp.asarray(table.codes, dtype=jnp.int32),
        jnp.asarray(table.scalar, dtype=dtype),
        jnp.asarray(table.vector, dtype=dtype),
    )


def face_bc(mesh: CompiledMesh, zone_codes, zone_scalar, zone_vector) -> FaceBC:
    """Gather zone BC data onto faces (inside jit)."""
    s = mesh.face_zone_slot
    # Zone VECTOR values are selected with a static Z-way where chain:
    # a gather from the tiny [Z,3] table produces an in-graph [F,3]
    # buffer that a minor-dim-tiling backend pads when it is reduced
    # over components (see ops/layout.py); the where chain costs ~0.
    Z = zone_codes.shape[0]
    vector = jnp.broadcast_to(zone_vector[0], s.shape + (3,))
    for z in range(1, Z):
        vector = jnp.where((s == z)[:, None], zone_vector[z], vector)
    return FaceBC(
        code=zone_codes[s],
        scalar=zone_scalar[s],
        vector=vector,
        zcode=zone_codes,
        zscalar=zone_scalar,
        zvector=zone_vector,
    )


def momentum_source_term(source, centroids, volumes):
    """Evaluate a user momentum source with the documented contract:
    ``f(centroids [C,3]) -> [C,3]`` (already volume-integrated) or
    ``f(centroids, volumes) -> [C,3]`` (receives LOCAL per-cell volumes
    — required for closures that integrate a per-unit-volume force, and
    the only form that works under shard_map). Dispatch counts REQUIRED
    positional parameters only, so capture-by-default-argument closures
    (``lambda cc, _g=g: ...``) keep the single-argument contract.
    Shared by both assembly paths (ops/assembly.py, ops/ck_ops.py)."""
    import inspect

    required = [
        prm
        for prm in inspect.signature(source).parameters.values()
        if prm.default is inspect.Parameter.empty
        and prm.kind
        in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD,
        )
    ]
    if len(required) >= 2:
        return source(centroids, volumes)
    return source(centroids)
