"""Checkpoint / warm-start.

The reference warm-starts from its text data file when one exists,
falling back to fresh initialization (tests.rs:84-86,195-197), with
cell order as the implicit schema and no mesh-consistency check. Here
checkpoints are compressed npz archives carrying a mesh fingerprint so
a checkpoint is never silently applied to a different mesh — plus the
same text-format warm-start path for compatibility.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import jax.numpy as jnp
import numpy as np

from orc_cfd.mesh.compile import CompiledMesh
from orc_cfd.solver.simple import FlowState


def _as_component_major(md, n_cells: int):
    """FlowState.mom_diag is component-major [3,C]; checkpoints written
    before that layout change stored [C,3]. Detect and transpose (the
    C==3 case is ambiguous but a 3-cell mesh is not a real workload)."""
    if md.ndim == 2 and md.shape[0] == n_cells and md.shape[1] == 3:
        return jnp.moveaxis(md, 0, -1)
    return md


def mesh_fingerprint(mesh: CompiledMesh) -> str:
    h = hashlib.sha256()
    h.update(np.int64(mesh.n_cells).tobytes())
    h.update(np.int64(mesh.n_faces).tobytes())
    h.update(np.asarray(mesh.cell_centroid, dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


def save_checkpoint(
    path, mesh: CompiledMesh, state: FlowState, iteration=0, turb=None
):
    """`turb` (solver.turbulence.TurbState) is included when given so
    RANS runs resume their k/eps/mu_t fields too."""
    extra = {}
    if turb is not None:
        extra = dict(
            turb_k=np.asarray(turb.k),
            turb_eps=np.asarray(turb.eps),
            turb_mu_t=np.asarray(turb.mu_t),
        )
    if state.flux is not None:
        # SIMPLE_FC conservative stored flux ([C,K] on the ck path,
        # [F] face-major): resuming WITHOUT it would re-seed from an
        # interpolation and lose exact conservation. The layout must
        # match the resuming run's step type — a mismatch fails loudly
        # on shape.
        extra["flux"] = np.asarray(state.flux)
    np.savez_compressed(
        path,
        vel=np.asarray(state.vel),
        p=np.asarray(state.p),
        mom_diag=np.asarray(state.mom_diag),
        iteration=np.int64(iteration),
        mesh_fingerprint=np.bytes_(mesh_fingerprint(mesh).encode()),
        **extra,
    )


def load_checkpoint(path, mesh: CompiledMesh, with_turbulence=False):
    """Returns (FlowState, iteration) — or (FlowState, TurbState|None,
    iteration) with `with_turbulence=True`. Raises ValueError on a mesh
    mismatch."""
    with np.load(path) as z:
        fp = bytes(z["mesh_fingerprint"]).decode()
        if fp != mesh_fingerprint(mesh):
            raise ValueError(
                f"checkpoint {path} was written for a different mesh "
                f"(fingerprint {fp})"
            )
        state = FlowState(
            vel=jnp.asarray(z["vel"], mesh.dtype),
            p=jnp.asarray(z["p"], mesh.dtype),
            # Back-compat: checkpoints written before the component-
            # major FlowState layout store mom_diag as [C,3].
            mom_diag=_as_component_major(
                jnp.asarray(z["mom_diag"], mesh.dtype), mesh.n_cells
            ),
            flux=(
                jnp.asarray(z["flux"], mesh.dtype) if "flux" in z else None
            ),
        )
        if not with_turbulence:
            return state, int(z["iteration"])
        turb = None
        if "turb_k" in z:
            from orc_cfd.solver.turbulence import TurbState

            turb = TurbState(
                k=jnp.asarray(z["turb_k"], mesh.dtype),
                eps=jnp.asarray(z["turb_eps"], mesh.dtype),
                mu_t=jnp.asarray(z["turb_mu_t"], mesh.dtype),
            )
        return state, turb, int(z["iteration"])


def load_or_initialize(
    path: Optional[str],
    mesh: CompiledMesh,
    table,
    mu: float,
    rho: float,
) -> FlowState:
    """Warm-start semantics of the reference harness (tests.rs:84-86):
    resume from `path` if it exists (npz checkpoint or reference-format
    text data), else run field initialization."""
    from orc_cfd.solver.init_fields import initialize_flow

    if path and os.path.exists(path):
        if path.endswith(".npz"):
            state, _ = load_checkpoint(path, mesh)
            return state
        from orc_cfd.io.data import read_data

        vel, p = read_data(path)
        if vel.shape[0] != mesh.n_cells:
            raise ValueError(
                f"data file {path} has {vel.shape[0]} cells, mesh has "
                f"{mesh.n_cells}"
            )
        if mesh.cell_order is not None:
            # Text files are in raw-mesh cell order (the format's
            # implicit schema, io.rs:519-571); map into the compiled
            # (RCM) order: compiled[i] = raw[cell_order[i]].
            import numpy as np

            order = np.asarray(mesh.cell_order)
            vel, p = vel[order], p[order]
        return FlowState(
            vel=jnp.asarray(vel, mesh.dtype),
            p=jnp.asarray(p, mesh.dtype),
            mom_diag=jnp.ones((3, mesh.n_cells), mesh.dtype),
        )
    return initialize_flow(mesh, table, mu, rho)
