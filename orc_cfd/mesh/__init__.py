from orc_cfd.mesh.zones import BoundaryTable, CellZone, FaceCondition, FaceZone  # noqa: F401
from orc_cfd.mesh.compile import CompiledMesh, compile_mesh  # noqa: F401
from orc_cfd.mesh.tgrid import RawMesh, parse_tgrid, read_mesh  # noqa: F401
from orc_cfd.mesh.generate import structured_box_mesh, write_tgrid  # noqa: F401
