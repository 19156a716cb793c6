"""ctypes bindings for the native TGRID parser.

Builds `native/tgrid_reader.cpp` on demand with g++ (cached as a .so
next to the source) and exposes `parse_tgrid_native(path) -> RawMesh`.
Falls back silently to the pure-Python parser when the toolchain or the
library is unavailable (`read_mesh` handles the dispatch).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from orc_cfd.mesh.tgrid import RawMesh
from orc_cfd.mesh.zones import CellZone, FaceCondition, FaceZone

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "tgrid_reader.cpp",
)
_LIB_PATH = os.path.join(os.path.dirname(_SRC), "libtgrid.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[str]:
    if os.path.exists(_LIB_PATH) and os.path.getmtime(
        _LIB_PATH
    ) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", _LIB_PATH, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.tgrid_parse.restype = ctypes.c_void_p
        lib.tgrid_parse.argtypes = [ctypes.c_char_p]
        lib.tgrid_error.restype = ctypes.c_char_p
        lib.tgrid_dim.argtypes = [ctypes.c_void_p]
        for fn in (
            "tgrid_n_points",
            "tgrid_n_faces",
            "tgrid_n_cells",
            "tgrid_total_face_nodes",
            "tgrid_n_periodic",
        ):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        lib.tgrid_points.argtypes = [ctypes.c_void_p, dp]
        for fn in (
            "tgrid_face_counts",
            "tgrid_face_nodes",
            "tgrid_face_cells",
            "tgrid_face_zone",
            "tgrid_periodic_pairs",
        ):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ip]
        lib.tgrid_n_zones.argtypes = [ctypes.c_void_p]
        lib.tgrid_zone_info.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.tgrid_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def parse_tgrid_native(path: str) -> RawMesh:
    lib = _load()
    if lib is None:
        raise RuntimeError("native TGRID parser unavailable")
    h = lib.tgrid_parse(path.encode())
    if not h:
        raise ValueError(
            f"native TGRID parse failed: "
            f"{lib.tgrid_error().decode() or 'unknown error'}"
        )
    try:
        dim = lib.tgrid_dim(h)
        n_pts = lib.tgrid_n_points(h)
        n_faces = lib.tgrid_n_faces(h)
        n_cells = lib.tgrid_n_cells(h)
        total_nodes = lib.tgrid_total_face_nodes(h)

        points = np.empty((n_pts, 3), dtype=np.float64)
        lib.tgrid_points(h, points.reshape(-1))
        counts = np.empty(n_faces, dtype=np.int64)
        lib.tgrid_face_counts(h, counts)
        nodes_flat = np.empty(total_nodes, dtype=np.int64)
        lib.tgrid_face_nodes(h, nodes_flat)
        face_cells = np.empty(n_faces * 2, dtype=np.int64)
        lib.tgrid_face_cells(h, face_cells)
        face_zone = np.empty(n_faces, dtype=np.int64)
        lib.tgrid_face_zone(h, face_zone)
        n_per = lib.tgrid_n_periodic(h)
        periodic_pairs = np.empty(max(n_per, 1) * 2, dtype=np.int64)
        if n_per:
            lib.tgrid_periodic_pairs(h, periodic_pairs)
        periodic_pairs = periodic_pairs[: n_per * 2].reshape(n_per, 2)

        face_zones = {}
        name_buf = ctypes.create_string_buffer(256)
        for i in range(lib.tgrid_n_zones(h)):
            zid = ctypes.c_int64()
            bc = ctypes.c_int64()
            lib.tgrid_zone_info(h, i, ctypes.byref(zid), ctypes.byref(bc), name_buf, 256)
            face_zones[int(zid.value)] = FaceZone(
                zone_id=int(zid.value),
                zone_type=FaceCondition(int(bc.value)),
                name=name_buf.value.decode(),
            )
    finally:
        lib.tgrid_free(h)

    offsets = np.zeros(n_faces + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    face_nodes = [
        nodes_flat[offsets[i] : offsets[i + 1]] for i in range(n_faces)
    ]
    return RawMesh(
        dim=dim,
        points=points,
        face_nodes=face_nodes,
        face_cells=face_cells.reshape(n_faces, 2),
        face_zone_id=face_zone,
        face_zones=face_zones,
        cell_zones={},
        n_cells=int(n_cells),
        periodic_pairs=periodic_pairs,
    )
