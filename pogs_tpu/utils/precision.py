"""Matmul-precision control.

On NVIDIA GPUs from Ampere on, XLA may run float32 matrix products in TF32
(a 10-bit mantissa, ~1e-3 relative error) — fatal for a solver converging
to 1e-4..1e-7 tolerances: splitting iterations stall just above tolerance.
Every jitted solver entry point is traced under ``jax.default_matmul_precision('highest')`` so all dots,
einsums, and norms inside inherit full f32 accumulation, without touching
the user's global JAX configuration.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Decorator: trace ``fn`` with matmul precision pinned to 'highest'."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
