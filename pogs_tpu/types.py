"""Core types: function library enums, SoA function vectors, cones, settings.

Parity notes (citations into /root/reference):
  - ``Function`` mirrors the 16-entry enum at src/include/prox_lib.h:23-38
    (same names, same integer values — the C ABI exposes these ints,
    src/interface_c/pogs_c.h:51-69).
  - ``FunctionObj`` encodes c*h(a*x - b) + d*x + (e/2)*x^2 with the convexity
    clamps c,e >= 0 (src/include/prox_lib.h:40-70).
  - ``FunctionVector`` is the struct-of-arrays form: the ``h``
    codes are *static* (numpy, known at trace time) so prox dispatch
    specializes at compile time to only the function types present; the
    numeric parameters a,b,c,d,e are traced jnp arrays (so they can be
    vmapped, e.g. over a lambda path).
  - ``Cone`` mirrors src/include/prox_lib_cone.h:23-29.
  - ``Status`` mirrors PogsStatus at src/include/pogs.h:31-37.
  - Defaults in ``SolverSettings`` mirror src/include/pogs.h:18-28.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence, Union

import numpy as np
import jax
import jax.numpy as jnp


class Function(enum.IntEnum):
    """Scalar function library h(x). Values match the reference C enum."""

    ABS = 0        # f(x) = |x|
    EXP = 1        # f(x) = e^x
    HUBER = 2      # f(x) = huber(x)
    IDENTITY = 3   # f(x) = x
    INDBOX01 = 4   # f(x) = I(0 <= x <= 1)
    INDEQ0 = 5     # f(x) = I(x = 0)
    INDGE0 = 6     # f(x) = I(x >= 0)
    INDLE0 = 7     # f(x) = I(x <= 0)
    LOGISTIC = 8   # f(x) = log(1 + e^x)
    MAXNEG0 = 9    # f(x) = max(0, -x)
    MAXPOS0 = 10   # f(x) = max(0, x)
    NEGENTR = 11   # f(x) = x log(x)
    NEGLOG = 12    # f(x) = -log(x)
    RECIPR = 13    # f(x) = 1/x
    SQUARE = 14    # f(x) = (1/2) x^2
    ZERO = 15      # f(x) = 0


# Aliases matching the reference's k-prefixed spelling, for familiarity.
kAbs = Function.ABS
kExp = Function.EXP
kHuber = Function.HUBER
kIdentity = Function.IDENTITY
kIndBox01 = Function.INDBOX01
kIndEq0 = Function.INDEQ0
kIndGe0 = Function.INDGE0
kIndLe0 = Function.INDLE0
kLogistic = Function.LOGISTIC
kMaxNeg0 = Function.MAXNEG0
kMaxPos0 = Function.MAXPOS0
kNegEntr = Function.NEGENTR
kNegLog = Function.NEGLOG
kRecipr = Function.RECIPR
kSquare = Function.SQUARE
kZero = Function.ZERO


class Cone(enum.IntEnum):
    """Cone types. Values match the reference C enum (prox_lib_cone.h:23-29)."""

    ZERO = 0        # { x : x = 0 }
    NON_NEG = 1     # { x : x >= 0 }
    NON_POS = 2     # { x : x <= 0 }
    SOC = 3         # { (p, x) : ||x||_2 <= p }
    SDP = 4         # { X : X >= 0, packed lower-triangular }
    EXP_PRIMAL = 5  # cl{ (x,y,z) : y e^(x/y) <= z, y > 0 }
    EXP_DUAL = 6    # cl{ (u,v,w) : -u e^(v/u) <= e w, u < 0 }


class Status(enum.IntEnum):
    """Solver exit status. Values match PogsStatus (pogs.h:31-37)."""

    SUCCESS = 0
    INFEASIBLE = 1
    UNBOUNDED = 2
    MAX_ITER = 3
    NAN_FOUND = 4
    ERROR = 5


@dataclasses.dataclass
class FunctionObj:
    """A single term c*h(a*x - b) + d*x + (e/2) x^2 (prox_lib.h:40-70).

    Convenience scalar form; solver-facing code uses ``FunctionVector``.
    Negative c or e are clamped to 0 (the function would be non-convex).
    """

    h: Function = Function.ZERO
    a: float = 1.0
    b: float = 0.0
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0

    def __post_init__(self):
        self.c = max(self.c, 0.0)
        self.e = max(self.e, 0.0)


class FunctionVector:
    """Struct-of-arrays vector of FunctionObj terms.

    ``h`` is a static numpy int array (trace-time constant → compile-time
    prox specialization); a,b,c,d,e are parameter *data* — kept as host
    numpy arrays (or passed-through jax arrays) and handed to the jitted
    solve as arguments.  Host-side storage is deliberate: no eager device
    ops happen at construction, so building a problem dispatches nothing.
    Scalar parameters broadcast to the full length.
    """

    __slots__ = ("h", "a", "b", "c", "d", "e", "n")

    def __init__(
        self,
        h: Union[Function, int, Sequence[int], np.ndarray],
        n: Optional[int] = None,
        a: Any = 1.0,
        b: Any = 0.0,
        c: Any = 1.0,
        d: Any = 0.0,
        e: Any = 0.0,
        dtype: Any = None,
    ):
        h_arr = np.asarray(h, dtype=np.int32)
        if h_arr.ndim == 0:
            if n is None:
                raise ValueError("scalar h requires explicit n")
            h_arr = np.full((n,), int(h_arr), dtype=np.int32)
        if n is not None and h_arr.shape[0] != n:
            raise ValueError(f"h has length {h_arr.shape[0]}, expected {n}")
        self.h = h_arr
        self.n = h_arr.shape[0]
        if dtype is None:
            dtype = np.dtype(jnp.result_type(float))
        np_dtype = np.dtype(str(np.dtype(dtype)))

        def _vec(v):
            if isinstance(v, jax.Array):
                # Already on device: pass through untouched (no d2h).
                if v.ndim == 0:
                    raise ValueError("scalar device params not supported; pass float")
                if v.shape[0] != self.n:
                    raise ValueError(
                        f"parameter length {v.shape[0]} != objective length {self.n}"
                    )
                return v
            arr = np.asarray(v, dtype=np_dtype)
            if arr.ndim == 0:
                arr = np.full((self.n,), arr, dtype=np_dtype)
            elif arr.shape[0] != self.n:
                raise ValueError(
                    f"parameter length {arr.shape[0]} != objective length {self.n}"
                )
            return arr

        def _clamped(v):
            # Convexity clamps (prox_lib.h:62-69). Device arrays are clamped
            # lazily inside the jitted solve instead.
            arr = _vec(v)
            if isinstance(arr, np.ndarray):
                arr = np.maximum(arr, 0)
            return arr

        self.a = _vec(a)
        self.b = _vec(b)
        self.c = _clamped(c)
        self.d = _vec(d)
        self.e = _clamped(e)

    @property
    def params(self):
        """The traced parameter tuple (a, b, c, d, e)."""
        return (self.a, self.b, self.c, self.d, self.e)

    def to_device(self) -> "FunctionVector":
        """Move host params to the default device in ONE bundled transfer
        (idempotent).  Called by the solver so repeated solves with the same
        FunctionVector never re-upload parameters."""
        if any(not isinstance(p, jax.Array) for p in self.params):
            self.a, self.b, self.c, self.d, self.e = jax.device_put(self.params)
        return self

    @property
    def dtype(self):
        return self.a.dtype

    def h_key(self) -> bytes:
        """Hashable key for compile-cache purposes."""
        return self.h.tobytes()

    @staticmethod
    def from_objs(objs: Sequence[FunctionObj], dtype: Any = None) -> "FunctionVector":
        h = np.array([int(o.h) for o in objs], dtype=np.int32)
        return FunctionVector(
            h,
            a=np.array([o.a for o in objs]),
            b=np.array([o.b for o in objs]),
            c=np.array([o.c for o in objs]),
            d=np.array([o.d for o in objs]),
            e=np.array([o.e for o in objs]),
            dtype=dtype,
        )

    def replace_params(self, a=None, b=None, c=None, d=None, e=None) -> "FunctionVector":
        new = FunctionVector.__new__(FunctionVector)
        new.h = self.h
        new.n = self.n
        new.a = self.a if a is None else a
        new.b = self.b if b is None else b
        new.c = self.c if c is None else c
        new.d = self.d if d is None else d
        new.e = self.e if e is None else e
        return new


@dataclasses.dataclass(frozen=True)
class ConeConstraint:
    """One cone constraint over a set of coordinate indices.

    Mirrors ConeConstraint at prox_lib_cone.h:31-42: ``cone`` plus the index
    list of the entries of x (or y) that belong to it.
    """

    cone: Cone
    indices: tuple

    def __init__(self, cone: Cone, indices):
        object.__setattr__(self, "cone", Cone(cone))
        object.__setattr__(self, "indices", tuple(int(i) for i in indices))

    def __len__(self):
        return len(self.indices)


# Solver defaults — mirror src/include/pogs.h:18-28.
DEFAULT_ABS_TOL = 1e-4
DEFAULT_REL_TOL = 1e-3
DEFAULT_RHO = 1.0
DEFAULT_MAX_ITER = 2500
DEFAULT_VERBOSE = 0


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Solver knobs. Defaults mirror pogs.h:18-28 (verbose defaults quiet).

    These are *static* w.r.t. jit: changing them recompiles. That matches
    their role as algorithm configuration, and lets XLA constant-fold the
    tolerance ladder.
    """

    abs_tol: float = DEFAULT_ABS_TOL
    rel_tol: float = DEFAULT_REL_TOL
    rho: float = DEFAULT_RHO
    max_iter: int = DEFAULT_MAX_ITER
    verbose: int = DEFAULT_VERBOSE
    adaptive_rho: bool = True
    gap_stop: bool = False
    # Exact-tolerance mode: residuals in the original (unscaled) space,
    # alpha = 1.0, tighter projection tolerances (cone problems use this;
    # see pogs.cpp:102-110).
    use_exact_tol: bool = False
    # Anderson acceleration (documented API of the reference:
    # docs/api/configuration.md:150-196; off by default).
    use_anderson: bool = False
    anderson_mem: int = 5
    anderson_start: int = 10
    # Indirect (CGLS) projector controls.
    cgls_max_iter: int = 500
    # Active-set polish for LP-shaped HSDE cone solves (solver/hsde.py):
    # periodic masked-Cholesky projection onto the guessed active face,
    # adopted only if it passes the full convergence test.  Cuts tight-
    # tolerance LP tails from O(10^4) DR iterations to O(10^3).
    polish: bool = True

    def replace(self, **kw) -> "SolverSettings":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SolverResult:
    """Outputs of one solve (mirrors the reference result surface:
    x, y, mu, lambda, optval, final_iter, status — pogs.h:70-86)."""

    x: jax.Array
    y: jax.Array
    mu: jax.Array
    nu: jax.Array  # the reference calls this lambda
    optval: jax.Array
    final_iter: jax.Array
    status: Status
    # Residual diagnostics at exit.
    nrm_r: Optional[jax.Array] = None
    nrm_s: Optional[jax.Array] = None
    gap: Optional[jax.Array] = None
    rho: Optional[jax.Array] = None
    solve_time: Optional[float] = None

    @property
    def lam(self):
        return self.nu

    def as_dict(self):
        d = {
            "x": np.asarray(self.x),
            "y": np.asarray(self.y),
            "mu": np.asarray(self.mu),
            "l": np.asarray(self.nu),
            "optval": float(self.optval),
            "iterations": int(self.final_iter),
            "status": int(self.status),
        }
        if self.solve_time is not None:
            d["solve_time"] = self.solve_time
        return d
