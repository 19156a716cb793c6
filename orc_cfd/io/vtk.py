"""Legacy-VTK unstructured-grid writer (ParaView/VisIt compatible).

The reference has no VTK path (its plotter consumes a bespoke text
format, examples/plot_output.py); this writes the general-polyhedron
legacy format so any mesh this framework can read — including mixed
and polyhedral TGRID zones — round-trips into standard tooling:

- 2D meshes -> VTK_POLYGON cells (faces are edges; each cell's edge
  set is chained into an ordered boundary loop)
- 3D meshes -> VTK_POLYHEDRON cells (face-stream encoding, so no
  canonical hex/tet node ordering is ever needed)

Cell-centered fields are written as CELL_DATA scalars/vectors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np

from orc_cfd.mesh.tgrid import RawMesh


def _cell_faces(raw: RawMesh):
    """Per-cell list of face indices (host, ragged)."""
    out = [[] for _ in range(raw.n_cells)]
    for f, (c0, c1) in enumerate(raw.face_cells):
        if c0 >= 0:
            out[c0].append(f)
        if c1 >= 0:
            out[c1].append(f)
    return out


def _polygon_loop(edges) -> list:
    """Chain a cell's edges (node-index pairs) into one ordered loop."""
    nxt: Dict[int, list] = {}
    for a, b in edges:
        nxt.setdefault(int(a), []).append(int(b))
        nxt.setdefault(int(b), []).append(int(a))
    start = next(iter(nxt))
    loop = [start]
    prev = -1
    while True:
        cands = [n for n in nxt[loop[-1]] if n != prev]
        if not cands:
            break
        prev, node = loop[-1], cands[0]
        if node == start:
            break
        loop.append(node)
        if len(loop) > len(nxt):  # non-manifold guard
            break
    return loop


def write_vtk(
    path: str,
    raw: Union[RawMesh, str],
    cell_data: Optional[Dict[str, np.ndarray]] = None,
    title: str = "orc_cfd solution",
):
    """Write a legacy ASCII .vtk unstructured grid.

    `raw` is a parsed `RawMesh` or a path to a TGRID .msh file.
    `cell_data` maps field name -> [C] scalar or [C, 3] vector array.
    """
    if isinstance(raw, str):
        from orc_cfd.mesh.tgrid import parse_tgrid

        with open(raw) as f:
            raw = parse_tgrid(f.read())
    cell_data = {
        k: np.asarray(v, dtype=np.float64) for k, v in (cell_data or {}).items()
    }
    for k, v in cell_data.items():
        if v.shape[0] != raw.n_cells:
            raise ValueError(
                f"field {k!r} has {v.shape[0]} entries for {raw.n_cells} cells"
            )

    cf = _cell_faces(raw)
    lines = [
        "# vtk DataFile Version 3.0",
        title,
        "ASCII",
        "DATASET UNSTRUCTURED_GRID",
        f"POINTS {len(raw.points)} double",
    ]
    pts = np.asarray(raw.points, dtype=np.float64)
    lines.extend(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}" for p in pts)

    cells, types = [], []
    if raw.dim == 2:
        for faces in cf:
            loop = _polygon_loop([raw.face_nodes[f] for f in faces])
            cells.append(
                f"{len(loop)} " + " ".join(str(n) for n in loop)
            )
            types.append(7)  # VTK_POLYGON
    else:
        for faces in cf:
            # Face-stream: nFaces (nPts p0 p1 ...) per face.
            stream = [len(faces)]
            for f in faces:
                fn = raw.face_nodes[f]
                stream.append(len(fn))
                stream.extend(int(n) for n in fn)
            cells.append(
                f"{len(stream)} " + " ".join(str(n) for n in stream)
            )
            types.append(42)  # VTK_POLYHEDRON
    total = sum(len(c.split()) for c in cells)
    lines.append(f"CELLS {raw.n_cells} {total}")
    lines.extend(cells)
    lines.append(f"CELL_TYPES {raw.n_cells}")
    lines.extend(str(t) for t in types)

    if cell_data:
        lines.append(f"CELL_DATA {raw.n_cells}")
        for name, v in cell_data.items():
            if v.ndim == 2 and v.shape[1] == 3:
                lines.append(f"VECTORS {name} double")
                lines.extend(
                    f"{r[0]:.17g} {r[1]:.17g} {r[2]:.17g}" for r in v
                )
            else:
                lines.append(f"SCALARS {name} double 1")
                lines.append("LOOKUP_TABLE default")
                lines.extend(f"{x:.17g}" for x in v.ravel())

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_solution_vtk(path: str, raw: Union[RawMesh, str], state, extra=None):
    """Write a FlowState (velocity vector + pressure) as VTK cell data."""
    data = {
        "velocity": np.asarray(state.vel),
        "pressure": np.asarray(state.p),
    }
    if extra:
        data.update({k: np.asarray(v) for k, v in extra.items()})
    write_vtk(path, raw, cell_data=data)


def read_vtk_cell_data(path: str) -> Dict[str, np.ndarray]:
    """Minimal reader for files this module wrote (round-trip tests)."""
    fields: Dict[str, np.ndarray] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    n_cells = 0
    while i < len(lines):
        t = lines[i].split()
        if not t:
            i += 1
            continue
        if t[0] == "CELL_DATA":
            n_cells = int(t[1])
        elif t[0] == "SCALARS" and n_cells:
            name = t[1]
            vals = []
            j = i + 2  # skip LOOKUP_TABLE
            while len(vals) < n_cells:
                vals.extend(float(x) for x in lines[j].split())
                j += 1
            fields[name] = np.array(vals)
            i = j - 1
        elif t[0] == "VECTORS" and n_cells:
            name = t[1]
            rows = []
            j = i + 1
            while len(rows) < n_cells:
                rows.append([float(x) for x in lines[j].split()])
                j += 1
            fields[name] = np.array(rows)
            i = j - 1
        i += 1
    return fields


def _main():  # pragma: no cover - small utility entry
    import argparse

    ap = argparse.ArgumentParser(description="Convert a TGRID mesh to VTK")
    ap.add_argument("mesh")
    ap.add_argument("out")
    a = ap.parse_args()
    write_vtk(a.out, a.mesh)
    print(f"wrote {a.out} ({os.path.getsize(a.out)} bytes)")


if __name__ == "__main__":  # pragma: no cover
    _main()
