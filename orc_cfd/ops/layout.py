"""Layout-safe gathers.

XLA assigns gather outputs a row-major layout, and a backend that tiles
the two minor dims pads a small minor dim (K = 6 face slots, 3
components) many times over. Gathering mesh tables the naive way
(``face_vals[cell_faces]`` -> [C,K], ``vel[face_owner]`` -> [F,3],
``normal[cell_faces]`` -> [C,K,3]) can therefore materialize padded
buffers there.

Emitting the gather with the big gathered dimension LAST and
transposing back logically avoids that: XLA folds the transpose into
the consumers, so the padded buffer never exists. Whether the GPU
backend needs this is unmeasured (ROADMAP design item 4).

``take(x, idx)`` is the drop-in replacement for ``x[idx]`` used at
every gather site in the assembly/gradient/interpolation graphs.
"""

from __future__ import annotations

import jax.numpy as jnp


def take(x, idx):
    """``x[idx]`` with a layout-safe gather (see module docstring).

    Supports x of shape [N, *feat] (feat of ndim 0..2) and idx of shape
    [] / [F] / [C, K]; returns ``x[idx]`` exactly (pure layout change).
    """
    feat = x.shape[1:]
    if not feat:
        if idx.ndim <= 1:
            return x[idx]  # 1-D output: no padded minor dim
        # [C,K] index: gather [K,C] (C minor), transpose back.
        return x[idx.T].T
    # Flatten features and put them in FRONT so the gathered big dim
    # stays minor, then restore the logical order.
    xt = x.reshape((x.shape[0], -1)).T  # [pf, N]
    if idx.ndim <= 1:
        g = xt[:, idx]  # [pf, F]
        return g.T.reshape(idx.shape + feat)
    g = xt[:, idx.T]  # [pf, K, C]
    return jnp.transpose(g, (2, 1, 0)).reshape(idx.shape + feat)
