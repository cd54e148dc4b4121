"""Vector prox / function evaluation with compile-time dispatch on h.

The vectorized replacement for the reference's elementwise switch over
FunctionObj records (prox_lib.h:206-230, 325-349, 503-546).  Because the
``h`` codes of a :class:`~pogs_tpu.types.FunctionVector` are static numpy
data, we specialize at trace time: only the function types actually present
in the problem are emitted, each as one full-width elementwise pass with a
constant boolean mask.  A single-type objective (the common case — lasso,
ridge, logistic, ...) compiles to exactly one fused elementwise stage with
no dispatch at all.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pogs_tpu.types import Function, FunctionVector
from pogs_tpu.prox.scalar import PROX, FUNC, SUBGRAD


def _present_types(h: np.ndarray):
    """Unique function codes with constant masks (trace-time)."""
    types = np.unique(h)
    return [(Function(int(t)), h == t) for t in types]


def prox_eval(fv: FunctionVector, v, rho):
    """prox_{f, rho}(v) elementwise, f_i = c_i h_i(a_i x - b_i) + d_i x + (e_i/2) x^2.

    Applies the generic parameter transform of the reference
    (prox_lib.h:206-230):

        v'   = a (v rho - d) / (e + rho) - b
        rho' = (e + rho) / (c a^2)
        out  = (prox_h(v', rho') + b) / a
    """
    a, b, c, d, e = fv.params
    rho = jnp.asarray(rho, fv.dtype)
    # a = 0 makes the h-term constant: prox is the pure quadratic/linear
    # minimizer (v*rho - d)/(e + rho).  Compute with a safe a and select.
    a_safe = jnp.where(a == 0, jnp.ones_like(a), a)
    vt = a_safe * (v * rho - d) / (e + rho) - b
    rt = (e + rho) / (c * a_safe * a_safe)

    out = None
    for ftype, mask in _present_types(fv.h):
        branch = PROX[ftype](vt, rt)
        if out is None and mask.all():
            out = branch
        elif out is None:
            out = jnp.where(jnp.asarray(mask), branch, jnp.zeros_like(branch))
        else:
            out = jnp.where(jnp.asarray(mask), branch, out)
    return jnp.where(a == 0, (v * rho - d) / (e + rho), (out + b) / a_safe)


def func_eval(fv: FunctionVector, x):
    """sum_i c_i h_i(a_i x_i - b_i) + d_i x_i + (e_i/2) x_i^2 (prox_lib.h:325-349)."""
    a, b, c, d, e = fv.params
    z = a * x - b
    hval = None
    for ftype, mask in _present_types(fv.h):
        branch = FUNC[ftype](z)
        if hval is None and mask.all():
            hval = branch
        elif hval is None:
            hval = jnp.where(jnp.asarray(mask), branch, jnp.zeros_like(branch))
        else:
            hval = jnp.where(jnp.asarray(mask), branch, hval)
    return jnp.sum(c * hval + d * x + 0.5 * e * x * x)


def proj_subgrad_eval(fv: FunctionVector, v, x):
    """Project v onto the subdifferential of f at x (prox_lib.h:469-494)."""
    a, b, c, d, e = fv.params
    ac = a * c
    affine = d + e * x  # result when a == 0 or c == 0
    safe_ac = jnp.where(ac == 0, jnp.ones_like(ac), ac)
    vt = (v - d - e * x) / safe_ac
    axb = a * x - b
    out = None
    for ftype, mask in _present_types(fv.h):
        branch = SUBGRAD[ftype](vt, axb)
        if out is None and mask.all():
            out = branch
        elif out is None:
            out = jnp.where(jnp.asarray(mask), branch, jnp.zeros_like(branch))
        else:
            out = jnp.where(jnp.asarray(mask), branch, out)
    return jnp.where(ac == 0, affine, ac * out + affine)


def scale_f(fv: FunctionVector, d_scale) -> FunctionVector:
    """Scale f by the row equilibration d: a,d /= d_i, e /= d_i^2 (pogs.cpp:608-612)."""
    return fv.replace_params(
        a=fv.a / d_scale, d=fv.d / d_scale, e=fv.e / (d_scale * d_scale)
    )


def scale_g(fv: FunctionVector, e_scale) -> FunctionVector:
    """Scale g by the column equilibration e: a,d *= e_j, e *= e_j^2 (pogs.cpp:613-617)."""
    return fv.replace_params(
        a=fv.a * e_scale, d=fv.d * e_scale, e=fv.e * (e_scale * e_scale)
    )
