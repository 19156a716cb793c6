from orc_cfd.io.data import (  # noqa: F401
    read_data,
    write_data,
    write_gradients,
)
from orc_cfd.io.vtk import (  # noqa: F401
    read_vtk_cell_data,
    write_solution_vtk,
    write_vtk,
)
from orc_cfd.io.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_or_initialize,
    mesh_fingerprint,
    save_checkpoint,
)
