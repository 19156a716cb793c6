from orc_cfd.solver.krylov import SolveInfo, iterative_solve  # noqa: F401
