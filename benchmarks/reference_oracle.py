"""ctypes binding to the REFERENCE solver (libpogs_cpu) — the parity oracle.

This module builds the upstream reference implementation out-of-source
(``cmake -S <ref> -B <repo>/build/reference``) and binds its C ABI
(reference ``src/interface_c/pogs_c.h:75-243``):

  * ``PogsD``            — dense graph form (double)
  * ``PogsSparseD``      — CSR/CSC graph form
  * ``PogsConeD``        — cone form, CGLS projector
  * ``PogsConeQD``       — cone form + dense quadratic objective
  * ``PogsConeDirectD``  — cone form, direct (Cholesky) projector
  * ``PogsConeDirectQD`` — direct + quadratic objective

It exists for two purposes (VERDICT round-1 items 1 and 2):

  1. **Value-parity fuzzing** (``tests/test_reference_parity.py``): the JAX
     solver and the actual reference binary must agree on objective values
     across randomized graph-form and cone-form problems.
  2. **Same-host head-to-head benchmarking** (``benchmarks/head_to_head.py``):
     wall-clock numbers measured on THIS machine against the actual
     reference, not against README constants recorded on other hardware.

Nothing here ships in the ``pogs_tpu`` package; it is a dev/CI tool.  The
reference source tree is located via ``$POGS_REFERENCE_DIR`` (default
``/root/reference``); a prebuilt library can be pointed at directly with
``$POGS_REFERENCE_LIB``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "reference"
DEFAULT_REF_DIR = Path(os.environ.get("POGS_REFERENCE_DIR", "/root/reference"))

_lib = None
_load_error: Optional[str] = None


class ConeConstraintC(ctypes.Structure):
    """ABI mirror of ``struct ConeConstraintC`` (pogs_c.h:137-141)."""

    _fields_ = [
        ("cone", ctypes.c_int),
        ("indices", ctypes.POINTER(ctypes.c_uint)),
        ("size", ctypes.c_uint),
    ]


def _candidate_lib_paths():
    env = os.environ.get("POGS_REFERENCE_LIB")
    if env:
        yield Path(env)
    for name in ("libpogs_cpu.so", "libpogs_cpu.dylib"):
        yield BUILD_DIR / "lib" / name


def build_reference(ref_dir: Path = DEFAULT_REF_DIR) -> Optional[Path]:
    """CMake-configure + build the reference CPU library out-of-source.

    Returns the shared-library path, or None if the source tree or the
    toolchain is unavailable.  BLAS/LAPACK are passed explicitly because
    minimal images ship only the versioned runtime libraries (no ``-dev``
    symlinks), which FindBLAS cannot discover on its own.
    """
    if not (ref_dir / "CMakeLists.txt").exists():
        return None
    lib = BUILD_DIR / "lib" / "libpogs_cpu.so"
    if lib.exists():
        return lib
    # cmake-configuring an UNTRUSTED source tree executes arbitrary
    # commands at configure time, so a fresh build requires an explicit
    # opt-in; loading an already-built library above stays automatic.
    if os.environ.get("POGS_REFERENCE_BUILD") != "1":
        return None
    blas = "/lib/x86_64-linux-gnu/libblas.so.3"
    lapack = "/lib/x86_64-linux-gnu/liblapack.so.3"
    cfg = [
        "cmake", "-S", str(ref_dir), "-B", str(BUILD_DIR),
        "-DCMAKE_BUILD_TYPE=Release",
        "-DPOGS_BUILD_GPU=OFF", "-DPOGS_BUILD_TESTS=OFF",
        "-DPOGS_BUILD_EXAMPLES=OFF",
    ]
    if os.path.exists(blas) and os.path.exists(lapack):
        cfg += [f"-DBLAS_LIBRARIES={blas}", f"-DLAPACK_LIBRARIES={lapack}"]
    try:
        subprocess.run(cfg, check=True, capture_output=True, timeout=300)
        subprocess.run(
            ["cmake", "--build", str(BUILD_DIR), "--target", "pogs_cpu_shared"],
            check=True, capture_output=True, timeout=600,
        )
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    return lib if lib.exists() else None


_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_int)  # enum FUNCTION*
_U = ctypes.POINTER(ctypes.c_uint)


def _graph_argtypes():
    return (
        [ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, _D]
        + [_D] * 5 + [_F]   # f arrays
        + [_D] * 5 + [_F]   # g arrays
        + [ctypes.c_double] * 3
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int]
        + [_D, _D, _D, _D, _U]
    )


def _cone_argtypes(with_P: bool):
    head = [ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t, _D, _D, _D]
    if with_P:
        head.append(_D)
    return (
        head
        + [ctypes.POINTER(ConeConstraintC), ctypes.c_size_t] * 2
        + [ctypes.c_double] * 3
        + [ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int]
        + [_D, _D, _D, _D, _U]
    )


def load():
    """Load (building if necessary) the reference library; cached."""
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    path = None
    for cand in _candidate_lib_paths():
        if cand.exists():
            path = cand
            break
    if path is None:
        path = build_reference()
    if path is None:
        _load_error = "reference library unavailable (source tree or toolchain missing)"
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:  # pragma: no cover
        _load_error = str(exc)
        return None
    lib.PogsD.argtypes = _graph_argtypes()
    lib.PogsD.restype = ctypes.c_int
    sparse_args = _graph_argtypes()
    # PogsSparseD inserts (nnz, data, ptr, ind) after (ord, m, n).
    lib.PogsSparseD.argtypes = (
        sparse_args[:3]
        + [ctypes.c_size_t, _D, ctypes.POINTER(ctypes.c_int),
           ctypes.POINTER(ctypes.c_int)]
        + sparse_args[4:]
    )
    lib.PogsSparseD.restype = ctypes.c_int
    for name, with_p in (("PogsConeD", False), ("PogsConeQD", True),
                         ("PogsConeDirectD", False), ("PogsConeDirectQD", True)):
        fn = getattr(lib, name)
        fn.argtypes = _cone_argtypes(with_p)
        fn.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _dptr(arr: np.ndarray):
    return arr.ctypes.data_as(_D)


def ref_solve_graph(
    A,
    f,
    g,
    rho: float = 1.0,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-3,
    max_iter: int = 2500,
    verbose: int = 0,
    adaptive_rho: bool = True,
    gap_stop: bool = False,
) -> dict:
    """Solve min f(Ax) + g(x) with the reference ``PogsD``/``PogsSparseD``.

    ``f``/``g`` are ``pogs_tpu.types.FunctionVector`` (host numpy params).
    Returns the reference result-dict contract (x, y, l, optval, iterations,
    status).  Sparse ``A`` (scipy CSR/CSC) routes to ``PogsSparseD``.
    """
    lib = load()
    if lib is None:
        raise RuntimeError(f"reference library unavailable: {_load_error}")

    def _params(fv, length):
        h = np.ascontiguousarray(fv.h, dtype=np.int32)
        out = [h]
        for p in fv.params:
            out.append(np.ascontiguousarray(np.asarray(p), dtype=np.float64))
        assert all(a.shape[0] == length for a in out)
        return out

    sparse = hasattr(A, "tocsr") and not isinstance(A, np.ndarray)
    if sparse:
        m, n = A.shape
    else:
        A = np.ascontiguousarray(np.asarray(A), dtype=np.float64)
        m, n = A.shape
    fh, fa, fb, fc, fd, fe = _params(f, m)
    gh, ga, gb, gc, gd, ge = _params(g, n)
    x = np.zeros(n)
    y = np.zeros(m)
    lam = np.zeros(m)
    optval = np.zeros(1)
    final_iter = np.zeros(1, dtype=np.uint32)
    ROW_MAJ = 1
    fhp = fh.ctypes.data_as(_F)
    ghp = gh.ctypes.data_as(_F)
    tail = (
        float(rho), float(abs_tol), float(rel_tol),
        int(max_iter), int(verbose), int(bool(adaptive_rho)), int(bool(gap_stop)),
        _dptr(x), _dptr(y), _dptr(lam), _dptr(optval),
        final_iter.ctypes.data_as(_U),
    )
    if sparse:
        csr = A.tocsr()
        data = np.ascontiguousarray(csr.data, dtype=np.float64)
        ptr = np.ascontiguousarray(csr.indptr, dtype=np.int32)
        ind = np.ascontiguousarray(csr.indices, dtype=np.int32)
        status = lib.PogsSparseD(
            ROW_MAJ, m, n, csr.nnz, _dptr(data),
            ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ind.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            _dptr(fa), _dptr(fb), _dptr(fc), _dptr(fd), _dptr(fe), fhp,
            _dptr(ga), _dptr(gb), _dptr(gc), _dptr(gd), _dptr(ge), ghp,
            *tail,
        )
    else:
        status = lib.PogsD(
            ROW_MAJ, m, n, _dptr(A),
            _dptr(fa), _dptr(fb), _dptr(fc), _dptr(fd), _dptr(fe), fhp,
            _dptr(ga), _dptr(gb), _dptr(gc), _dptr(gd), _dptr(ge), ghp,
            *tail,
        )
    return {
        "x": x, "y": y, "l": lam,
        "optval": float(optval[0]),
        "iterations": int(final_iter[0]),
        "status": int(status),
    }


def _marshal_cones(cones: Sequence, keepalive: list):
    """Build a ConeConstraintC array from (cone:int, indices) pairs or
    pogs_tpu ConeConstraint objects."""
    arr = (ConeConstraintC * max(len(cones), 1))()
    for i, cc in enumerate(cones):
        if hasattr(cc, "cone"):
            cone, indices = int(cc.cone), cc.indices
        else:
            cone, indices = int(cc[0]), cc[1]
        idx = np.ascontiguousarray(np.asarray(indices), dtype=np.uint32)
        keepalive.append(idx)
        arr[i].cone = cone
        arr[i].indices = idx.ctypes.data_as(_U)
        arr[i].size = idx.shape[0]
    return arr


def ref_solve_cone(
    A,
    b,
    c,
    Kx: Sequence = (),
    Ky: Sequence = (),
    P=None,
    direct: bool = False,
    rho: float = 1.0,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-3,
    max_iter: int = 2500,
    verbose: int = 0,
    adaptive_rho: bool = True,
    gap_stop: bool = False,
) -> dict:
    """Solve min cᵀx (+½xᵀPx) s.t. b − Ax ∈ K_y, x ∈ K_x via the reference
    ``PogsCone{,Q}{,Direct}D`` entry points (pogs_c.h:167-243)."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"reference library unavailable: {_load_error}")
    A = np.ascontiguousarray(np.asarray(A), dtype=np.float64)
    m, n = A.shape
    b = np.ascontiguousarray(np.asarray(b), dtype=np.float64)
    c = np.ascontiguousarray(np.asarray(c), dtype=np.float64)
    keep: list = []
    kx = _marshal_cones(Kx, keep)
    ky = _marshal_cones(Ky, keep)
    x = np.zeros(n)
    y = np.zeros(m)
    lam = np.zeros(m)
    optval = np.zeros(1)
    final_iter = np.zeros(1, dtype=np.uint32)
    ROW_MAJ = 1
    name = {
        (False, False): "PogsConeD",
        (False, True): "PogsConeQD",
        (True, False): "PogsConeDirectD",
        (True, True): "PogsConeDirectQD",
    }[(bool(direct), P is not None)]
    fn = getattr(lib, name)
    args = [ROW_MAJ, m, n, _dptr(A), _dptr(b), _dptr(c)]
    if P is not None:
        P = np.ascontiguousarray(np.asarray(P), dtype=np.float64)
        args.append(_dptr(P))
    args += [
        kx, len(Kx), ky, len(Ky),
        float(rho), float(abs_tol), float(rel_tol),
        int(max_iter), int(verbose), int(bool(adaptive_rho)), int(bool(gap_stop)),
        _dptr(x), _dptr(y), _dptr(lam), _dptr(optval),
        final_iter.ctypes.data_as(_U),
    ]
    status = fn(*args)
    return {
        "x": x, "y": y, "l": lam,
        "optval": float(optval[0]),
        "iterations": int(final_iter[0]),
        "status": int(status),
    }
