"""Device meshes and sharding helpers.

The reference is a single-node solver (OpenMP + threaded BLAS + single-GPU
CUDA, SURVEY.md §2.9) — this module is the capability it lacks:
scale-out over a ``jax.sharding.Mesh``.

Strategy (SURVEY.md §5.8): shard the *row* blocks of A (and the y-side
vectors) across the mesh; x-side vectors replicate.  Every operation the
solver performs then lowers to per-shard compute plus XLA collectives:

  * ``A @ x``      → local gemv, y stays row-sharded (no comms)
  * ``A.T @ y``    → local gemv + psum over the row axis (one all-reduce)
  * Gram ``AᵀA``   → local AᵢᵀAᵢ + psum (init-time only)
  * norms / dots   → local partials + psum

We rely on GSPMD propagation: placing A with ``NamedSharding(mesh,
P('rows', None))`` and jitting the unmodified solver gives exactly this
plan — the solver code stays single-device-pure, the compiler inserts the
collectives.  A second mesh axis ('batch') shards vmapped λ-path /
scenario batches (data-parallel axis; zero cross-talk).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize multi-host JAX (idempotent). Returns the global device
    count.  On a single host this is a no-op; on a pod/multi-slice it wires
    jax.distributed so meshes span all hosts (collectives ride ICI within a
    slice, DCN across slices).

    Re-initialization is tolerated (idempotent), but a genuine init failure
    — unreachable coordinator, mismatched process counts — RAISES after
    logging: a silently-degraded single-host solve on what the caller
    believes is a pod would produce wrong shardings and wasted hardware.
    """
    try:
        if num_processes is not None and num_processes > 1:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        elif coordinator_address is not None:
            jax.distributed.initialize(coordinator_address=coordinator_address)
    except RuntimeError as exc:
        if "already" in str(exc).lower():
            pass  # idempotent re-init
        else:
            logging.getLogger(__name__).error(
                "jax.distributed.initialize failed (coordinator=%s, "
                "num_processes=%s, process_id=%s): %s",
                coordinator_address, num_processes, process_id, exc,
            )
            raise
    return len(jax.devices())


def make_mesh(
    shape: Union[int, Tuple[int, ...], None] = None,
    axis_names: Sequence[str] = ("rows",),
    devices=None,
) -> Mesh:
    """Create a device mesh. Default: 1-D 'rows' mesh over all devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,)
    elif isinstance(shape, int):
        shape = (shape,)
    if int(np.prod(shape)) != len(devices):
        devices = devices[: int(np.prod(shape))]
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def shard_matrix(A, mesh: Mesh, axis: str = "rows"):
    """Place A row-sharded over ``axis`` (replicated over other axes)."""
    return jax.device_put(A, NamedSharding(mesh, P(axis, None)))


def shard_matrix_cols(A, mesh: Mesh, axis: str = "rows"):
    """Place A COLUMN-sharded over ``axis`` — the wide-A plan (SURVEY §7).

    Under GSPMD the operation costs invert relative to the row plan:

      * ``A @ x``   → local gemv over the column block + psum (one
                      all-reduce of a length-m vector)
      * ``A.T @ y`` → local gemv, result stays column-sharded (no comms)
      * Gram trick  → for wide A the projector factors the m×m ``AAᵀ``,
                      computed as a psum of local AᵢAᵢᵀ outer blocks

    x-side vectors (x, e, g-params) shard with the columns; y-side vectors
    replicate.  Pick this plan when n ≫ m (the all-reduced vector is the
    short dimension)."""
    return jax.device_put(A, NamedSharding(mesh, P(None, axis)))


def auto_shard(A, mesh: Mesh, axis: str = "rows"):
    """Shard A by its aspect ratio: rows when tall (m ≥ n), columns when
    wide — so the psum'd vector in the hot matvec pair is always the SHORT
    side, minimizing bytes over ICI per iteration."""
    m, n = A.shape
    return shard_matrix(A, mesh, axis) if m >= n else shard_matrix_cols(A, mesh, axis)


def replicate(x, mesh: Mesh):
    """Place x fully replicated on the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def row_sharding(mesh: Mesh, axis: str = "rows") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def col_sharding(mesh: Mesh, axis: str = "rows") -> NamedSharding:
    return NamedSharding(mesh, P(None, axis))


def pad_rows_to(A, b, multiple: int):
    """Zero-pad rows of (A, b) to a multiple (so row shards are equal).

    Zero rows are inert for graph-form objectives built with f_i = ZERO on
    the padding (a zero row contributes y_i = 0 and f_i(0) = 0).
    Returns (A_pad, b_pad, m_orig).
    """
    m = A.shape[0]
    m_pad = (-m) % multiple
    if m_pad == 0:
        return A, b, m
    A_pad = np.zeros((m + m_pad, A.shape[1]), dtype=np.asarray(A).dtype)
    A_pad[:m] = np.asarray(A)
    b_pad = np.zeros((m + m_pad,), dtype=np.asarray(b).dtype)
    b_pad[:m] = np.asarray(b)
    return A_pad, b_pad, m
