from orc_cfd.utils.settings import NumericalSettings, MatrixSolverSettings  # noqa: F401
