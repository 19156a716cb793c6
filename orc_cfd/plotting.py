"""Post-processing plots (headless, cross-platform).

Covers the reference plotter's capability surface
(examples/plot_output.py): pressure contours + velocity quiver, du/dy
contours, and the velocity profile against the analytical channel-flow
curve — minus the Windows-only figure tiler, plus an Agg backend so it
runs headless. Reads the same text data format (orc_cfd.io.data).

Usage:
    python -m orc_cfd.plotting out/solution --save
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _read_data_with_centroids(path):
    cents, vel, p = [], [], []
    with open(path) as f:
        for line in f:
            cols = line.strip().split("\t")
            if len(cols) != 3:
                continue
            cents.append(
                [float(x) for x in cols[0].strip("()").split(",")]
            )
            vel.append([float(x) for x in cols[1].strip("()").split(",")])
            p.append(float(cols[2]))
    return np.asarray(cents), np.asarray(vel), np.asarray(p)


def _read_gradients(path):
    cents, gv, gp = [], [], []
    with open(path) as f:
        for line in f:
            cols = line.replace("(", "").replace(")", "").split("\t")
            if len(cols) != 3:
                continue
            cents.append([float(x) for x in cols[0].split(", ")[:3]])
            gv.append([float(x) for x in cols[1].split(", ")[:9]])
            gp.append([float(x) for x in cols[2].split(", ")[:3]])
    return (
        np.asarray(cents),
        np.asarray(gv).reshape(-1, 3, 3),
        np.asarray(gp),
    )


def plot_2d(
    root: str,
    title: Optional[str] = None,
    save: bool = True,
    out_dir: Optional[str] = None,
):
    """Contour/quiver plots from `<root>.csv` (+ optional
    `<root>_gradients.csv`, `<root>_analytical.csv`). Returns the list
    of files written."""
    import matplotlib.tri as tri

    plt = _mpl()
    out_dir = out_dir or os.path.dirname(root) or "."
    base = os.path.basename(root)
    written = []

    cents, vel, p = _read_data_with_centroids(root + ".csv")
    x, y = cents[:, 0], cents[:, 1]
    u, v = vel[:, 0], vel[:, 1]

    have_grads = os.path.exists(root + "_gradients.csv")
    n_rows = 2 if have_grads else 1
    fig, axs = plt.subplots(
        nrows=n_rows, layout="constrained", sharex=True, squeeze=False
    )
    axs = axs[:, 0]
    if title:
        fig.suptitle(title)
    triang = tri.Triangulation(x, y)
    cm = axs[0].tricontourf(triang, p, levels=10)
    fig.colorbar(cm, ax=axs[0], label="Gage Pressure [Pa]")
    axs[0].quiver(x, y, u, v)
    axs[0].set_title("Velocity Vectors; Pressure Contours")
    axs[0].set_xlabel("X [m]")
    axs[0].set_ylabel("Y [m]")

    if have_grads:
        gc, gv, gp = _read_gradients(root + "_gradients.csv")
        du_dy = gv[:, 0, 1]
        cm2 = axs[1].tricontourf(
            tri.Triangulation(gc[:, 0], gc[:, 1]), du_dy, levels=20, cmap="RdBu"
        )
        axs[1].set_title("du/dy")
        fig.colorbar(cm2, ax=axs[1], label="Velocity gradient [1/s]")

    if save:
        fn = os.path.join(out_dir, base + "_contour_plots.png")
        fig.savefig(fn, dpi=200)
        written.append(fn)
    plt.close(fig)

    ana = root + "_analytical.csv"
    if os.path.exists(ana):
        fig, ax = plt.subplots()
        if title:
            fig.suptitle(title)
        ax.scatter(y, u, label="CFD data", s=8)
        ya, ua = np.loadtxt(ana, delimiter=",", unpack=True)
        ax.plot(ya, ua, label="Analytical solution", color="C1")
        ax.legend()
        ax.set_xlabel("Y [m]")
        ax.set_ylabel("U [m/s]")
        if save:
            fn = os.path.join(out_dir, base + "_velocity_profile.png")
            fig.savefig(fn, dpi=200)
            written.append(fn)
        plt.close(fig)
    return written


def _read_face_velocities(path):
    """Parse a face-velocity file: `id\\t(x, y, z)\\t(u, v, w)` per
    face (writer: io.data.write_face_velocities; reference consumer:
    plot_output.py:233-244)."""
    x, y, u, v = [], [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            _, cent, vel = line.split("\t")
            cx, cy = [float(s) for s in cent.strip("()\n").split(",")[:2]]
            vu, vv = [float(s) for s in vel.strip("()\n").split(",")[:2]]
            x.append(cx)
            y.append(cy)
            u.append(vu)
            v.append(vv)
    return np.asarray(x), np.asarray(y), np.asarray(u), np.asarray(v)


def plot_face_velocities(
    filenames,
    save: bool = True,
    out_dir: Optional[str] = None,
    title: Optional[str] = None,
):
    """Multi-file face-velocity comparison: one row per file, a shared
    u-contour color scale + a quiver scaled to the global velocity
    magnitude (reference: plot_output.py:220-260, headless / tri-based
    like plot_2d). Returns the list of files written."""
    import matplotlib.tri as tri

    plt = _mpl()
    if isinstance(filenames, (str, os.PathLike)):
        filenames = [filenames]
    out_dir = out_dir or os.path.dirname(str(filenames[0])) or "."
    data = [_read_face_velocities(f) for f in filenames]

    u_min = min(d[2].min() for d in data)
    u_max = max(d[2].max() for d in data)
    v_max = max(abs(d[3]).max() for d in data)
    arrow_scale = float(np.hypot(u_max, v_max)) * 30 or 1.0
    levels = np.linspace(u_min, u_max, 10) if u_max > u_min else 10

    fig, axs = plt.subplots(
        nrows=len(data), layout="constrained", sharex=True, sharey=True,
        squeeze=False,
    )
    axs = axs[:, 0]
    if title:
        fig.suptitle(title)
    cm = None
    for ax, fname, (x, y, u, v) in zip(axs, filenames, data):
        cm = ax.tricontourf(tri.Triangulation(x, y), u, levels=levels)
        ax.quiver(
            x, y, u, v, scale=arrow_scale, scale_units="width", width=0.002
        )
        ax.set_title(os.path.basename(str(fname)))
    fig.colorbar(cm, ax=axs, label="U [m/s]")
    written = []
    if save:
        fn = os.path.join(out_dir, "face_velocities.png")
        fig.savefig(fn, dpi=200)
        written.append(fn)
    plt.close(fig)
    return written


def write_analytical_profile(path, params, channel_height=None, n=128):
    """Write `<name>_analytical.csv` for plot_2d (reference:
    tests.rs:18-31)."""
    from orc_cfd.models.channel_flow import CHANNEL_HEIGHT, analytical_profile

    y, u = analytical_profile(params, channel_height or CHANNEL_HEIGHT, n)
    with open(path, "w") as f:
        for yi, ui in zip(y, u):
            f.write(f"{yi:.3e},{ui:.3e}\n")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Plot CFD output")
    ap.add_argument("root", help="data file base path (without .csv)")
    ap.add_argument("-t", "--title", default=None)
    ap.add_argument("--save", action="store_true", default=True)
    args = ap.parse_args()
    for f in plot_2d(args.root, args.title, save=True):
        print(f"wrote {f}")
