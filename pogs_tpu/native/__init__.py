"""ctypes bindings to the native host runtime (libpogs_tpu_native).

The native library (src/native/, C ABI in src/include/pogs_tpu_native.h) is
the host-side counterpart of the JAX solve path: a dependency-free C++
implementation of the same graph-form ADMM algorithm.  It serves

  * non-Python callers (the C ABI — parity with the reference's
    src/interface_c/pogs_c.h, reached from Python the same way the
    reference's packaged wheel works: pure ctypes, no pybind),
  * latency-critical small problems, where a host solve beats a device
    dispatch, and
  * cross-checking: an independent numerics oracle for the JAX solver
    (see tests/test_native.py).

Use :func:`is_available` to probe, :func:`build` to compile the library
in-tree (requires cmake + a C++20 compiler), and :class:`NativeDenseSolver`
/ :class:`NativeSparseSolver` or :func:`solve_graph_native` to solve.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from pogs_tpu.types import (
    ConeConstraint,
    Function,
    FunctionVector,
    SolverSettings,
    Status,
)

_REPO_ROOT = Path(__file__).resolve().parents[2]

_LIB_NAMES = (
    "libpogs_tpu_native.so",
    "libpogs_tpu_native.dylib",
    "pogs_tpu_native.dll",
)


def _candidate_paths():
    env = os.environ.get("POGS_TPU_NATIVE_LIB")
    if env:
        yield Path(env)
    here = Path(__file__).resolve().parent
    for name in _LIB_NAMES:
        yield here / name
        yield _REPO_ROOT / "build" / "lib" / name


_lib: Optional[ct.CDLL] = None
_lib_checked = False


class PogsNativeSettings(ct.Structure):
    _fields_ = [
        ("abs_tol", ct.c_double),
        ("rel_tol", ct.c_double),
        ("rho", ct.c_double),
        ("max_iter", ct.c_int32),
        ("verbose", ct.c_int32),
        ("adaptive_rho", ct.c_int32),
        ("gap_stop", ct.c_int32),
        ("warm_start", ct.c_int32),
        ("cgls_max_iter", ct.c_int32),
        ("polish", ct.c_int32),
    ]


class PogsNativeInfo(ct.Structure):
    _fields_ = [
        ("optval", ct.c_double),
        ("final_iter", ct.c_int32),
        ("status", ct.c_int32),
        ("nrm_r", ct.c_double),
        ("nrm_s", ct.c_double),
        ("gap", ct.c_double),
        ("rho_final", ct.c_double),
    ]


_D = ct.POINTER(ct.c_double)
_I32 = ct.POINTER(ct.c_int32)
_I64 = ct.POINTER(ct.c_int64)


class _ConeC(ct.Structure):
    _fields_ = [
        ("cone", ct.c_int32),
        ("indices", _I64),
        ("num_indices", ct.c_size_t),
    ]


def _bind(lib: ct.CDLL) -> ct.CDLL:
    lib.pogs_native_settings_default.argtypes = [ct.POINTER(PogsNativeSettings)]
    lib.pogs_native_settings_default.restype = None
    lib.pogs_native_version.restype = ct.c_int32

    lib.pogs_native_dense_new.argtypes = [ct.c_int32, ct.c_size_t, ct.c_size_t, _D]
    lib.pogs_native_dense_new.restype = ct.c_void_p
    lib.pogs_native_dense_free.argtypes = [ct.c_void_p]
    lib.pogs_native_dense_free.restype = None
    lib.pogs_native_dense_solve.argtypes = (
        [ct.c_void_p, ct.POINTER(PogsNativeSettings)]
        + [_I32] + [_D] * 5 + [_I32] + [_D] * 5
        + [_D] * 4 + [ct.POINTER(PogsNativeInfo)]
    )
    lib.pogs_native_dense_solve.restype = ct.c_int32

    lib.pogs_native_sparse_new.argtypes = [
        ct.c_size_t, ct.c_size_t, ct.c_size_t, _I64, _I64, _D,
    ]
    lib.pogs_native_sparse_new.restype = ct.c_void_p
    lib.pogs_native_sparse_free.argtypes = [ct.c_void_p]
    lib.pogs_native_sparse_free.restype = None
    lib.pogs_native_sparse_solve.argtypes = lib.pogs_native_dense_solve.argtypes
    lib.pogs_native_sparse_solve.restype = ct.c_int32

    lib.pogs_native_cone_new.argtypes = [
        ct.c_int32, ct.c_size_t, ct.c_size_t, _D,
        ct.POINTER(_ConeC), ct.c_size_t, ct.POINTER(_ConeC), ct.c_size_t,
    ]
    lib.pogs_native_cone_new.restype = ct.c_void_p
    lib.pogs_native_cone_sparse_new.argtypes = [
        ct.c_size_t, ct.c_size_t, ct.c_size_t, _I64, _I64, _D,
        ct.POINTER(_ConeC), ct.c_size_t, ct.POINTER(_ConeC), ct.c_size_t,
    ]
    lib.pogs_native_cone_sparse_new.restype = ct.c_void_p
    lib.pogs_native_cone_qp_new.argtypes = [
        ct.c_int32, ct.c_size_t, ct.c_size_t, _D, _D,
        ct.POINTER(_ConeC), ct.c_size_t,
    ]
    lib.pogs_native_cone_qp_new.restype = ct.c_void_p
    lib.pogs_native_cone_qp_sparse_new.argtypes = [
        ct.c_size_t, ct.c_size_t, ct.c_size_t, _I64, _I64, _D, _D,
        ct.POINTER(_ConeC), ct.c_size_t,
    ]
    lib.pogs_native_cone_qp_sparse_new.restype = ct.c_void_p
    lib.pogs_native_cone_free.argtypes = [ct.c_void_p]
    lib.pogs_native_cone_free.restype = None
    lib.pogs_native_cone_solve.argtypes = [
        ct.c_void_p, ct.POINTER(PogsNativeSettings), _D, _D,
        _D, _D, _D, _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_cone_solve.restype = ct.c_int32
    lib.pogs_native_lasso_cd.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, _D, _D,
        ct.POINTER(PogsNativeSettings),
        _D, _D, _D, _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_lasso_cd.restype = ct.c_int32
    lib.pogs_native_ridge_direct.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, _D, _D,
        ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_ridge_direct.restype = ct.c_int32
    lib.pogs_native_svm_dual_cd.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, ct.c_double,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_svm_dual_cd.restype = ct.c_int32
    lib.pogs_native_logistic_pn.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, _D,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_logistic_pn.restype = ct.c_int32
    lib.pogs_native_huber_irls.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, ct.c_double, _D,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_huber_irls.restype = ct.c_int32
    lib.pogs_native_nnls.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_nnls.restype = ct.c_int32
    return lib


def _load() -> Optional[ct.CDLL]:
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    for path in _candidate_paths():
        if path.is_file():
            try:
                _lib = _bind(ct.CDLL(str(path)))
                return _lib
            except OSError:
                continue
    return None


def is_available() -> bool:
    """True if the native library is loadable."""
    return _load() is not None


def build(build_dir: Optional[Path] = None, quiet: bool = True) -> Path:
    """Compile the native library in-tree with cmake+ninja (or make).

    Returns the path to the built library; raises on failure.
    """
    global _lib_checked, _lib
    build_dir = Path(build_dir) if build_dir else _REPO_ROOT / "build"
    out = subprocess.run(
        ["cmake", "-S", str(_REPO_ROOT), "-B", str(build_dir),
         "-DCMAKE_BUILD_TYPE=Release"],
        capture_output=quiet, text=True,
    )
    if out.returncode != 0:
        raise RuntimeError(f"cmake configure failed:\n{out.stderr}")
    out = subprocess.run(
        ["cmake", "--build", str(build_dir), "--target", "pogs_tpu_native"],
        capture_output=quiet, text=True,
    )
    if out.returncode != 0:
        raise RuntimeError(f"cmake build failed:\n{out.stderr}")
    _lib_checked = False
    _lib = None
    if not is_available():
        raise RuntimeError("native library built but not loadable")
    for p in _candidate_paths():
        if p.is_file():
            return p
    raise RuntimeError("unreachable")


def version() -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    return int(lib.pogs_native_version())


def _settings_struct(settings: SolverSettings, warm_start: bool) -> PogsNativeSettings:
    lib = _load()
    st = PogsNativeSettings()
    lib.pogs_native_settings_default(ct.byref(st))
    st.abs_tol = settings.abs_tol
    st.rel_tol = settings.rel_tol
    st.rho = settings.rho
    st.max_iter = settings.max_iter
    st.verbose = settings.verbose
    st.adaptive_rho = int(settings.adaptive_rho)
    st.gap_stop = int(settings.gap_stop)
    st.warm_start = int(warm_start)
    st.cgls_max_iter = settings.cgls_max_iter
    st.polish = int(settings.polish)
    return st


def _fv_arrays(fv: FunctionVector, n: int):
    h = np.ascontiguousarray(fv.h, dtype=np.int32)
    if h.shape[0] != n:
        raise ValueError(f"objective length {h.shape[0]} != {n}")
    params = [np.ascontiguousarray(np.asarray(p, dtype=np.float64))
              for p in fv.params]
    ptrs = [h.ctypes.data_as(_I32)] + [p.ctypes.data_as(_D) for p in params]
    return ptrs, (h, params)  # keep refs alive


class _NativeSolverBase:
    """Shared solve plumbing for the dense/sparse handles."""

    _handle = None
    m = 0
    n = 0

    def _solve_fn(self):
        raise NotImplementedError

    def solve(self, f: FunctionVector, g: FunctionVector,
              settings: Optional[SolverSettings] = None,
              warm_start: bool = False) -> dict:
        if self._handle is None:
            raise RuntimeError("solver already freed")
        settings = settings or SolverSettings()
        st = _settings_struct(settings, warm_start)
        f_ptrs, f_keep = _fv_arrays(f, self.m)
        g_ptrs, g_keep = _fv_arrays(g, self.n)
        x = np.empty(self.n)
        y = np.empty(self.m)
        mu = np.empty(self.n)
        nu = np.empty(self.m)
        info = PogsNativeInfo()
        status = self._solve_fn()(
            self._handle, ct.byref(st), *f_ptrs, *g_ptrs,
            x.ctypes.data_as(_D), y.ctypes.data_as(_D),
            mu.ctypes.data_as(_D), nu.ctypes.data_as(_D), ct.byref(info),
        )
        del f_keep, g_keep
        return {
            "x": x, "y": y, "mu": mu, "l": nu,
            "optval": float(info.optval),
            "iterations": int(info.final_iter),
            "status": Status(int(status)),
            "nrm_r": float(info.nrm_r),
            "nrm_s": float(info.nrm_s),
            "rho": float(info.rho_final),
        }

    def free(self):
        if self._handle is not None:
            self._free_fn()(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.free()
        except Exception:
            pass


class NativeDenseSolver(_NativeSolverBase):
    """Handle-based dense solver (factorization + warm start persist)."""

    def __init__(self, A):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native library not available; run pogs_tpu.native.build()"
            )
        A = np.ascontiguousarray(np.asarray(A, dtype=np.float64))
        if A.ndim != 2:
            raise ValueError("A must be 2-D")
        self.m, self.n = A.shape
        self._lib = lib
        self._handle = lib.pogs_native_dense_new(
            0, self.m, self.n, A.ctypes.data_as(_D)
        )
        if not self._handle:
            raise RuntimeError("pogs_native_dense_new failed")

    def _solve_fn(self):
        return self._lib.pogs_native_dense_solve

    def _free_fn(self):
        return self._lib.pogs_native_dense_free


class NativeSparseSolver(_NativeSolverBase):
    """Handle-based CSR solver (CGLS projector)."""

    def __init__(self, A):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native library not available; run pogs_tpu.native.build()"
            )
        try:
            import scipy.sparse as sp
            A = sp.csr_matrix(A)
        except ImportError as exc:  # pragma: no cover
            raise RuntimeError("scipy required for the sparse native path") from exc
        self.m, self.n = A.shape
        indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(A.indices, dtype=np.int64)
        data = np.ascontiguousarray(A.data, dtype=np.float64)
        self._lib = lib
        self._handle = lib.pogs_native_sparse_new(
            self.m, self.n, data.shape[0],
            indptr.ctypes.data_as(_I64), indices.ctypes.data_as(_I64),
            data.ctypes.data_as(_D),
        )
        if not self._handle:
            raise RuntimeError("pogs_native_sparse_new failed")

    def _solve_fn(self):
        return self._lib.pogs_native_sparse_solve

    def _free_fn(self):
        return self._lib.pogs_native_sparse_free


class NativeConeSolver:
    """Handle-based cone solver: min c'x (+ ½x'Px) s.t. b − Ax ∈ K_y, x ∈ K_x.

    Graph-form cone ADMM in exact-tolerance mode (same algorithm as the
    Python ConeSolver's non-HSDE path).  SDP blocks must be svec-packed
    (column-major lower triangle, √2-scaled off-diagonals — the CVXPY/SCS
    conic-data convention; same contract as ConeSolver(assume_svec=True)).
    ``P`` (dense n×n) selects the QP variant (counterpart of the
    reference's PogsConeQD/PogsConeDirectQD, pogs_c.h:167-243); K_x must
    then be empty, as in the reference (pogs.cpp:1941-1944).
    """

    def __init__(self, A, Kx=(), Ky=(), P=None):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native library not available; run pogs_tpu.native.build()"
            )
        sparse_in = hasattr(A, "tocsr") and not isinstance(A, np.ndarray)
        if sparse_in:
            import scipy.sparse as sp_mod
            A = sp_mod.csr_matrix(A)
            self.m, self.n = A.shape
        else:
            A = np.ascontiguousarray(np.asarray(A, dtype=np.float64))
            if A.ndim != 2:
                raise ValueError("A must be 2-D")
            self.m, self.n = A.shape
        self._lib = lib

        def pack(cones):
            cones = [c if isinstance(c, ConeConstraint) else
                     ConeConstraint(*c) for c in cones]
            idx_arrays = [np.asarray(c.indices, dtype=np.int64) for c in cones]
            arr = (_ConeC * max(len(cones), 1))()
            for i, (c, idx) in enumerate(zip(cones, idx_arrays)):
                arr[i].cone = int(c.cone)
                arr[i].indices = idx.ctypes.data_as(_I64)
                arr[i].num_indices = idx.shape[0]
            return arr, len(cones), idx_arrays

        kx_arr, n_kx, self._kx_keep = pack(Kx)
        ky_arr, n_ky, self._ky_keep = pack(Ky)
        if P is not None:
            if len(Kx) > 0:
                raise ValueError(
                    "quadratic objectives with K_x constraints are not "
                    "supported (composition would not be an exact prox; the "
                    "reference rejects this too, pogs.cpp:1941-1944)"
                )
            P = np.ascontiguousarray(np.asarray(P, dtype=np.float64))
            if P.shape != (self.n, self.n):
                raise ValueError(f"P must be {self.n}x{self.n}")
        if sparse_in:
            indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
            indices = np.ascontiguousarray(A.indices, dtype=np.int64)
            data = np.ascontiguousarray(A.data, dtype=np.float64)
            if P is not None:
                self._handle = lib.pogs_native_cone_qp_sparse_new(
                    self.m, self.n, data.shape[0],
                    indptr.ctypes.data_as(_I64), indices.ctypes.data_as(_I64),
                    data.ctypes.data_as(_D), P.ctypes.data_as(_D),
                    ky_arr, n_ky,
                )
            else:
                self._handle = lib.pogs_native_cone_sparse_new(
                    self.m, self.n, data.shape[0],
                    indptr.ctypes.data_as(_I64), indices.ctypes.data_as(_I64),
                    data.ctypes.data_as(_D), kx_arr, n_kx, ky_arr, n_ky,
                )
        elif P is not None:
            self._handle = lib.pogs_native_cone_qp_new(
                0, self.m, self.n, A.ctypes.data_as(_D), P.ctypes.data_as(_D),
                ky_arr, n_ky,
            )
        else:
            self._handle = lib.pogs_native_cone_new(
                0, self.m, self.n, A.ctypes.data_as(_D),
                kx_arr, n_kx, ky_arr, n_ky,
            )
        if not self._handle:
            raise RuntimeError(
                "pogs_native_cone_new failed (invalid cone specification)"
            )

    def solve(self, b, c, settings: Optional[SolverSettings] = None,
              warm_start: bool = False) -> dict:
        if self._handle is None:
            raise RuntimeError("solver already freed")
        settings = settings or SolverSettings()
        st = _settings_struct(settings, warm_start)
        b = np.ascontiguousarray(np.asarray(b, dtype=np.float64))
        c = np.ascontiguousarray(np.asarray(c, dtype=np.float64))
        if b.shape[0] != self.m or c.shape[0] != self.n:
            raise ValueError("b/c length mismatch")
        x = np.empty(self.n)
        y = np.empty(self.m)
        mu = np.empty(self.n)
        nu = np.empty(self.m)
        info = PogsNativeInfo()
        status = self._lib.pogs_native_cone_solve(
            self._handle, ct.byref(st),
            b.ctypes.data_as(_D), c.ctypes.data_as(_D),
            x.ctypes.data_as(_D), y.ctypes.data_as(_D),
            mu.ctypes.data_as(_D), nu.ctypes.data_as(_D), ct.byref(info),
        )
        return {
            "x": x, "y": y, "mu": mu, "l": nu,
            "optval": float(info.optval),
            "iterations": int(info.final_iter),
            "status": Status(int(status)),
            "nrm_r": float(info.nrm_r),
            "nrm_s": float(info.nrm_s),
        }

    def free(self):
        if self._handle is not None:
            self._lib.pogs_native_cone_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.free()
        except Exception:
            pass


def solve_cone_native(A, b, c, Kx=(), Ky=(), P=None,
                      settings: Optional[SolverSettings] = None, **kw) -> dict:
    """One-shot native cone solve (P selects the QP variant)."""
    if settings is None:
        settings = SolverSettings(**kw) if kw else SolverSettings()
    solver = NativeConeSolver(A, Kx=Kx, Ky=Ky, P=P)
    try:
        return solver.solve(b, c, settings)
    finally:
        solver.free()


def _lasso_shape(f: FunctionVector, g: FunctionVector):
    """Detect min ½‖y−b‖² + Σ l1|x| + ½Σ l2 x²  (lasso / elastic net).

    Returns (b, l1, l2) or None.  This is the shape the coordinate-
    descent fast path solves directly — an order of magnitude less
    arithmetic than the ADMM runtime on host-size problems."""
    if not (np.all(np.asarray(f.h) == int(Function.SQUARE))
            and np.all(np.asarray(g.h) == int(Function.ABS))):
        return None
    for v, want in ((f.a, 1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                    (g.a, 1.0), (g.b, 0.0), (g.d, 0.0)):
        if not np.all(np.asarray(v) == want):
            return None
    l1 = np.asarray(g.c, np.float64)
    l2 = np.asarray(g.e, np.float64)
    if np.any(l1 < 0) or np.any(l2 < 0):
        return None
    return (np.asarray(f.b, np.float64), l1, l2)


def lasso_cd(A, b, l1, l2=None, settings: Optional[SolverSettings] = None,
             x0=None) -> dict:
    """Native coordinate descent for elastic-net least squares
    (src/native/cd.hpp) — the algorithm class behind sklearn/glmnet,
    which the reference lacks entirely.  ``l1``/``l2`` broadcast to
    length n; ``x0`` warm-starts the sweeps."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native library not available; run pogs_tpu.native.build()")
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    m, n = A.shape
    b = np.ascontiguousarray(np.asarray(b, np.float64).ravel())
    l1 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(l1, np.float64), (n,)))
    l2 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(0.0 if l2 is None else l2, np.float64), (n,)))
    settings = settings or SolverSettings()
    st = _settings_struct(settings, x0 is not None)
    x = (np.zeros(n) if x0 is None
         else np.ascontiguousarray(np.asarray(x0, np.float64)).copy())
    y = np.empty(m)
    mu = np.empty(n)
    nu = np.empty(m)
    info = PogsNativeInfo()
    status = lib.pogs_native_lasso_cd(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D),
        l1.ctypes.data_as(_D), l2.ctypes.data_as(_D), ct.byref(st),
        x.ctypes.data_as(_D), y.ctypes.data_as(_D),
        mu.ctypes.data_as(_D), nu.ctypes.data_as(_D), ct.byref(info),
    )
    return {
        "x": x, "y": y, "mu": mu, "l": nu,
        "optval": float(info.optval),
        "iterations": int(info.final_iter),
        "status": Status(int(status)),
        "nrm_r": float(info.nrm_r),
        "nrm_s": float(info.nrm_s),
        "rho": 0.0,
        "algorithm": "cd",
    }


def _all_eq(v, want):
    return np.all(np.asarray(v) == want)


def _glm_shape(f: FunctionVector, g: FunctionVector):
    """Classify ridge / hinge-SVM / l1-logistic shapes for the GLM fast
    paths (src/native/glm.hpp).  Returns (kind, payload) or None."""
    fh = np.asarray(f.h)
    gh = np.asarray(g.h)
    # ridge: ½‖y−b‖² + ½Σ(c+e) x²
    if (np.all(fh == int(Function.SQUARE))
            and np.all(gh == int(Function.SQUARE))
            and all(_all_eq(v, w) for v, w in
                    ((f.a, 1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                     (g.a, 1.0), (g.b, 0.0), (g.d, 0.0)))):
        l2 = np.asarray(g.c, np.float64) + np.asarray(g.e, np.float64)
        if np.all(l2 >= 0):
            return ("ridge", (np.asarray(f.b, np.float64), l2))
    # labels for the margin losses arrive as a = -y with y in {-1, +1}
    y = -np.asarray(f.a, np.float64)
    labels_ok = np.all(np.abs(y) == 1.0)
    # svm: Σ max(0, 1−y a'x) + (λ/2)‖x‖²
    if (np.all(fh == int(Function.MAXPOS0)) and labels_ok
            and np.all(gh == int(Function.SQUARE))
            and all(_all_eq(v, w) for v, w in
                    ((f.b, -1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                     (g.a, 1.0), (g.b, 0.0), (g.d, 0.0), (g.e, 0.0)))):
        lam = np.asarray(g.c, np.float64)
        if lam.ndim == 0 or np.all(lam == lam.ravel()[0]):
            lam0 = float(np.ravel(lam)[0]) if lam.ndim else float(lam)
            if lam0 > 0:
                return ("svm", (y, lam0))
    # logistic: Σ log(1+exp(−y a'x)) + Σ l1|x|  (l1 may be 0 via ZERO g)
    if (np.all(fh == int(Function.LOGISTIC)) and labels_ok
            and all(_all_eq(v, w) for v, w in
                    ((f.b, 0.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0)))):
        l1 = _l1_or_none(g, gh)
        if l1 is not None:
            return ("logistic", (y, l1))
    # nnls: ½‖y−b‖² with x ≥ 0 (g = INDGE0); active-set via the native
    # PDAS needs the dense normal equations, so cap n.
    if (np.all(fh == int(Function.SQUARE))
            and np.all(gh == int(Function.INDGE0))
            and np.asarray(g.h).shape[0] <= 2000
            and all(_all_eq(v, w) for v, w in
                    ((f.a, 1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                     (g.a, 1.0), (g.b, 0.0), (g.d, 0.0), (g.e, 0.0)))):
        return ("nnls", (np.asarray(f.b, np.float64),))
    # huber: Σ huber_δ(a'x − b) + Σ l1|x|, encoded a=1/δ, b=b/δ, c=δ²
    # (api/graph.py::solve_huber)
    if (np.all(fh == int(Function.HUBER))
            and all(_all_eq(v, w) for v, w in ((f.d, 0.0), (f.e, 0.0)))):
        fa = np.asarray(f.a, np.float64)
        fc = np.asarray(f.c, np.float64)
        a0 = float(np.ravel(fa)[0]) if fa.ndim else float(fa)
        if (a0 > 0 and np.all(fa == a0)
                and np.allclose(fc * a0 * a0, 1.0, rtol=1e-12, atol=0)):
            l1 = _l1_or_none(g, gh)
            if l1 is not None:
                b_orig = np.asarray(f.b, np.float64) / a0
                return ("huber", (b_orig, 1.0 / a0, l1))
    return None


def _l1_or_none(g: FunctionVector, gh):
    """λ‖x‖₁ coefficients when g is ABS (or zeros when g is ZERO)."""
    if (np.all(gh == int(Function.ABS))
            and all(_all_eq(v, w) for v, w in
                    ((g.a, 1.0), (g.b, 0.0), (g.d, 0.0), (g.e, 0.0)))):
        l1 = np.asarray(g.c, np.float64)
        if np.all(l1 >= 0):
            return l1
        return None
    if np.all(gh == int(Function.ZERO)):
        return np.zeros(1)
    return None


def _glm_result(x, y_out, nu, A, optval, iters, status_code, kkt):
    # Graph-form dual convention: nu = grad f(y) (or a subgradient),
    # mu = -A'nu (in the subdifferential of g at the optimum).
    return {
        "x": x, "y": y_out, "mu": -(A.T @ nu), "l": nu,
        "optval": float(optval), "iterations": int(iters),
        "status": Status(int(status_code)),
        "nrm_r": 0.0, "nrm_s": float(kkt), "rho": 0.0,
    }


def ridge_direct(A, b, l2) -> dict:
    """Closed-form ridge: one Gram + Cholesky solve (min-dim dual form
    for wide A with uniform l2) — src/native/glm.hpp."""
    lib = _load()
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    m, n = A.shape
    b = np.ascontiguousarray(np.asarray(b, np.float64).ravel())
    l2 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(l2, np.float64), (n,)))
    x = np.empty(n)
    info = PogsNativeInfo()
    status = lib.pogs_native_ridge_direct(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D),
        l2.ctypes.data_as(_D), x.ctypes.data_as(_D), ct.byref(info))
    y_out = A @ x
    out = _glm_result(x, y_out, y_out - b, A, info.optval,
                      info.final_iter, status, info.nrm_s)
    out["algorithm"] = "ridge_direct"
    return out


def svm_cd(A, y, lam, settings: Optional[SolverSettings] = None) -> dict:
    """Hinge-loss SVM via liblinear-style dual coordinate descent
    (src/native/glm.hpp)."""
    lib = _load()
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    m, n = A.shape
    y = np.ascontiguousarray(np.asarray(y, np.float64).ravel())
    settings = settings or SolverSettings()
    st = _settings_struct(settings, False)
    x = np.empty(n)
    info = PogsNativeInfo()
    status = lib.pogs_native_svm_dual_cd(
        m, n, A.ctypes.data_as(_D), y.ctypes.data_as(_D), float(lam),
        ct.byref(st), x.ctypes.data_as(_D), ct.byref(info))
    z = A @ x
    # hinge subgradient wrt z: -y on violated margins, 0 on satisfied
    nu = np.where(y * z < 1.0, -y, 0.0)
    out = _glm_result(x, z, nu, A, info.optval, info.final_iter, status,
                      info.nrm_s)
    out["algorithm"] = "svm_dual_cd"
    return out


def logistic_pn(A, y, l1, settings: Optional[SolverSettings] = None,
                x0=None) -> dict:
    """L1 logistic regression via glmnet-style prox-Newton
    (src/native/glm.hpp): IRLS quadratic approximation, inner weighted
    lasso through the CD kernel, damped on the true loss."""
    lib = _load()
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    m, n = A.shape
    y = np.ascontiguousarray(np.asarray(y, np.float64).ravel())
    l1 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(l1, np.float64), (n,)))
    settings = settings or SolverSettings()
    st = _settings_struct(settings, x0 is not None)
    x = (np.zeros(n) if x0 is None
         else np.ascontiguousarray(np.asarray(x0, np.float64)).copy())
    info = PogsNativeInfo()
    status = lib.pogs_native_logistic_pn(
        m, n, A.ctypes.data_as(_D), y.ctypes.data_as(_D),
        l1.ctypes.data_as(_D), ct.byref(st), x.ctypes.data_as(_D),
        ct.byref(info))
    z = A @ x
    nu = -y / (1.0 + np.exp(y * z))  # gradient of the logistic loss
    out = _glm_result(x, z, nu, A, info.optval, info.final_iter, status,
                      info.nrm_s)
    out["algorithm"] = "logistic_pn"
    return out


def lasso_path_cd(A, b, lambdas, l2=0.0,
                  settings: Optional[SolverSettings] = None):
    """Warm-started λ-path through the CD fast path: each grid point
    starts from the previous solution, so interior steps cost a couple
    of confirmation sweeps (the reference's LassoPath pattern,
    examples/cpp/lasso_path.cpp, on the host runtime).  Returns a dict
    of stacked results: x (K, n), optval (K,), sweeps (K,)."""
    lambdas = np.asarray(lambdas, np.float64).ravel()
    xs, opts, sweeps = [], [], []
    x0 = None
    for lam in lambdas:
        out = lasso_cd(A, b, lam, l2, settings=settings, x0=x0)
        x0 = out["x"]
        xs.append(out["x"])
        opts.append(out["optval"])
        sweeps.append(out["iterations"])
    return {"x": np.stack(xs), "optval": np.asarray(opts),
            "sweeps": np.asarray(sweeps, np.int64),
            "lambdas": lambdas}


def nnls(A, b, settings: Optional[SolverSettings] = None) -> dict:
    """Nonnegative least squares via active-set on the normal equations
    (src/native/glm.hpp).  Raises nothing on rejection — returns status
    ERROR so the caller (solve_graph_native) can fall back to ADMM."""
    lib = _load()
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    m, n = A.shape
    b = np.ascontiguousarray(np.asarray(b, np.float64).ravel())
    settings = settings or SolverSettings()
    st = _settings_struct(settings, False)
    x = np.zeros(n)
    info = PogsNativeInfo()
    status = lib.pogs_native_nnls(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D), ct.byref(st),
        x.ctypes.data_as(_D), ct.byref(info))
    y_out = A @ x
    out = _glm_result(x, y_out, y_out - b, A, info.optval,
                      info.final_iter, status, info.nrm_s)
    out["algorithm"] = "nnls_pdas"
    return out


def huber_irls(A, b, delta, l1,
               settings: Optional[SolverSettings] = None, x0=None) -> dict:
    """Huber regression (+ optional l1) via IRLS / majorize-minimize
    (src/native/glm.hpp): each step solves a reweighted lasso through
    the CD core; monotone decrease, no line search."""
    lib = _load()
    A = np.ascontiguousarray(np.asarray(A, np.float64))
    m, n = A.shape
    b = np.ascontiguousarray(np.asarray(b, np.float64).ravel())
    l1 = np.ascontiguousarray(np.broadcast_to(
        np.asarray(l1, np.float64), (n,)))
    settings = settings or SolverSettings()
    st = _settings_struct(settings, x0 is not None)
    x = (np.zeros(n) if x0 is None
         else np.ascontiguousarray(np.asarray(x0, np.float64)).copy())
    info = PogsNativeInfo()
    status = lib.pogs_native_huber_irls(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D), float(delta),
        l1.ctypes.data_as(_D), ct.byref(st), x.ctypes.data_as(_D),
        ct.byref(info))
    z = A @ x
    nu = np.clip(z - b, -float(delta), float(delta))  # huber' at residual
    out = _glm_result(x, z, nu, A, info.optval, info.final_iter, status,
                      info.nrm_s)
    out["algorithm"] = "huber_irls"
    return out


def solve_graph_native(A, f: FunctionVector, g: FunctionVector,
                       settings: Optional[SolverSettings] = None, **kw) -> dict:
    """One-shot native solve of min f(y) + g(x) s.t. y = Ax.

    Dense ndarray inputs use the direct projector; scipy-sparse inputs use
    CGLS.  Classic GLM shapes take specialized fast paths: lasso /
    elastic net → coordinate descent (:func:`lasso_cd`), ridge → direct
    Cholesky, hinge SVM → dual CD, l1-logistic → prox-Newton.  Accepts
    the same keyword tolerances as the Python API.
    """
    if settings is None:
        settings = SolverSettings(**kw) if kw else SolverSettings()
    if not hasattr(A, "tocsr"):
        shape = _lasso_shape(f, g)
        if shape is not None:
            b, l1, l2 = shape
            return lasso_cd(A, b, l1, l2, settings=settings)
        glm = _glm_shape(f, g)
        if glm is not None:
            kind, payload = glm
            if kind == "ridge":
                out = ridge_direct(A, payload[0], payload[1])
                # Singular normal equations (l2 = 0 with rank-deficient
                # A'A): fall back to the ADMM runtime below.
                if out["status"] != Status.ERROR:
                    return out
            elif kind == "svm":
                return svm_cd(A, payload[0], payload[1], settings=settings)
            elif kind == "huber":
                return huber_irls(A, payload[0], payload[1], payload[2],
                                  settings=settings)
            elif kind == "nnls":
                # The exact active-set costs several dense factorizations;
                # the ADMM loop is faster at benchmark tolerances.  Route
                # to PDAS only when the caller asks for accuracy ADMM
                # cannot reach; rejection falls back to ADMM either way.
                if settings.abs_tol <= 1e-7:
                    out = nnls(A, payload[0], settings=settings)
                    if out["status"] != Status.ERROR:
                        return out
            else:
                return logistic_pn(A, payload[0], payload[1],
                                   settings=settings)
        solver = NativeDenseSolver(A)
    else:
        solver = NativeSparseSolver(A)
    try:
        return solver.solve(f, g, settings)
    finally:
        solver.free()
