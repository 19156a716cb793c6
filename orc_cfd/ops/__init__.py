from orc_cfd.ops.fields import FaceBC, device_bc, face_bc  # noqa: F401
from orc_cfd.ops.interpolation import (  # noqa: F401
    face_flux,
    face_pressure,
    face_velocity,
)
from orc_cfd.ops.gradients import (  # noqa: F401
    pressure_gradient,
    velocity_gradient,
)
from orc_cfd.ops.spmv import ell_spmv  # noqa: F401
