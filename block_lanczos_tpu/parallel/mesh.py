"""Device mesh construction.

The reference builds an MPI_Dims_create 2D process grid with row/column
communicators (reference: mpi/lanczos_modp.c:505-566).  The equivalent
here is a jax.sharding.Mesh with axes ("rows", "cols"); the mesh follows
the algorithm alone, since NVLink joins every GPU of a host to every other:

  * rows — partitions the kernel dimension N_eff (vector blocks v/Av/p and
    the matrix's N-bands); the Mt*v partial reduction psums over it;
  * cols — partitions the other dimension M_eff (the tmp block and the
    matrix's M-bands); the M*tmp partial reduction psums over it.

cols == 1 degenerates to pure row sharding (one collective per iteration);
a balanced grid cuts per-device collective volume by ~sqrt(K), the same
communication argument the reference makes for its 2D grid (rapport 3.1 via
SURVEY.md section 2).
"""

from __future__ import annotations

import jax
import numpy as np

ROWS_AXIS = "rows"
COLS_AXIS = "cols"


def make_mesh(n_devices: int | None = None) -> jax.sharding.Mesh:
    """1D (rows-only) mesh: shape (n_devices, 1)."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    return make_mesh_grid(n_devices, 1)


def make_mesh_grid(rows: int, cols: int) -> jax.sharding.Mesh:
    devices = jax.devices()
    need = rows * cols
    if need > len(devices):
        raise ValueError(
            f"requested {rows}x{cols} devices, only {len(devices)} available")
    arr = np.array(devices[:need]).reshape(rows, cols)
    return jax.sharding.Mesh(arr, (ROWS_AXIS, COLS_AXIS))


def balanced_grid(n_devices: int) -> tuple[int, int]:
    """MPI_Dims_create-style near-square factorization (rows >= cols)."""
    best = (n_devices, 1)
    c = 1
    while c * c <= n_devices:
        if n_devices % c == 0:
            best = (n_devices // c, c)
        c += 1
    return best
