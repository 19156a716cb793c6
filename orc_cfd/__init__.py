"""orc_cfd — an unstructured finite-volume incompressible CFD framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capability surface of the
reference solver (reidprichard/ORC, Rust): TGRID mesh ingest, SIMPLE
pressure-velocity coupling, a menu of discretization schemes, sparse
iterative solvers (Jacobi / BiCGSTAB / colored Gauss-Seidel / AMG), field
initialization, checkpointing, and validation cases — built for accelerators from
the start:

- The mesh is compiled on host into padded SoA index arrays (ELL-style),
  so all assembly runs as vectorized gather/segment ops on device.
- The entire SIMPLE iteration (assembly -> momentum solves -> pressure
  correction -> update) is a single jitted function driven by `lax.scan`.
- Multi-chip runs shard the cell dimension over a `jax.sharding.Mesh`
  with halo exchange via collectives (`orc_cfd.parallel`).

Double precision is the default (the physics of the reference demands it);
import of this package enables JAX x64 unless ORC_X64=0 is set.
"""

import os as _os

import jax as _jax

if _os.environ.get("ORC_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

from orc_cfd.utils.settings import (  # noqa: E402
    DiffusionScheme,
    GradientReconstruction,
    MatrixSolverSettings,
    MomentumScheme,
    NumericalSettings,
    PreconditionMethod,
    PressureInterpolation,
    PressureVelocityCoupling,
    SolutionMethod,
    VelocityInterpolation,
    TVD_LUD,
    TVD_QUICK,
    TVD_UMIST,
)
from orc_cfd.mesh import (  # noqa: E402
    BoundaryTable,
    CompiledMesh,
    FaceCondition,
    read_mesh,
    structured_box_mesh,
)

__version__ = "0.1.0"

__all__ = [
    "BoundaryTable",
    "CompiledMesh",
    "DiffusionScheme",
    "FaceCondition",
    "GradientReconstruction",
    "MatrixSolverSettings",
    "MomentumScheme",
    "NumericalSettings",
    "PreconditionMethod",
    "PressureInterpolation",
    "PressureVelocityCoupling",
    "SolutionMethod",
    "VelocityInterpolation",
    "TVD_LUD",
    "TVD_QUICK",
    "TVD_UMIST",
    "read_mesh",
    "structured_box_mesh",
    "__version__",
]
