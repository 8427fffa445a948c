"""ctypes bindings for the native (C++) float64 factor engine.

Counterpart of ``safeopt_tpu/native/__init__.py``, over the port's own
copy of the engine, ``host_factor.cpp`` beside this file. ``g++ -O3
-shared -fPIC`` builds it at first use into the repository's ignored
``build/safeopt_torch/``, named by a hash of the source, and the build is
written to a temporary file there and renamed into place: a process that
builds at the same time (pytest's workers) never loads a half-written
library. ``available()`` is False when no compiler is found or the build
fails, and ``gp/host_math.HostFactor`` then takes SciPy, as in the JAX
package. This is a host library: it runs no device code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "gram", "cholesky_lower", "tri_inverse_lower",
           "border_append", "library_path"]

_SRC = Path(__file__).resolve().parent / "host_factor.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "safeopt_torch"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_D = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"libhostfactor_{digest.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return so
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _build() if _SRC.exists() else None
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    ci, cd = ctypes.c_int, ctypes.c_double
    lib.gram_rbf.argtypes = [_D, ci, _D, ci, ci, _D, cd, _D]
    lib.gram_matern32.argtypes = [_D, ci, _D, ci, ci, _D, cd, _D]
    lib.gram_matern52.argtypes = [_D, ci, _D, ci, ci, _D, cd, _D]
    lib.gram_exponential.argtypes = [_D, ci, _D, ci, ci, _D, cd, _D]
    lib.gram_ratquad.argtypes = [_D, ci, _D, ci, ci, _D, cd, cd, _D]
    lib.gram_stdperiodic.argtypes = [_D, ci, _D, ci, ci, _D, _D, cd, _D]
    lib.gram_linear.argtypes = [_D, ci, _D, ci, ci, _D, _D]
    lib.gram_cosine.argtypes = [_D, ci, _D, ci, ci, _D, cd, _D]
    lib.gram_poly.argtypes = [_D, ci, _D, ci, ci, cd, cd, cd, cd, _D]
    lib.gram_mlp.argtypes = [_D, ci, _D, ci, ci, _D, cd, cd, _D]
    lib.cholesky_lower.argtypes = [_D, ci, ci]
    lib.tri_inverse_lower.argtypes = [_D, ci, ci, _D]
    lib.border_append.argtypes = [_D, _D, _D, ci, ci, _D, cd, cd, _D]
    for f in (lib.gram_rbf, lib.gram_matern32, lib.gram_matern52,
              lib.gram_exponential, lib.gram_ratquad, lib.gram_stdperiodic,
              lib.gram_linear, lib.gram_cosine, lib.gram_poly, lib.gram_mlp,
              lib.cholesky_lower, lib.tri_inverse_lower, lib.border_append):
        f.restype = ci
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native engine built and loaded on this host."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def gram(kind: str, X: np.ndarray, Z: np.ndarray, ls, var: float,
         power: float = None, period=None, scale: float = None,
         bias: float = None) -> np.ndarray:
    """Float64 gram k(X, Z) over every column of X and Z: 'rbf' |
    'matern32' | 'matern52' | 'exponential' | 'cosine' | 'ratquad' (pass
    ``power``) | 'stdperiodic' (pass ``period``) | 'linear' (per-column
    weights in ``ls``; ``var`` unused) | 'poly' (pass ``scale`` and
    ``bias``; the order in ``power``) | 'mlp' (weight variances in
    ``ls``, the bias variance in ``bias``). ``RuntimeError`` past 64
    columns, which the engine refuses."""
    lib = _load()
    X = np.ascontiguousarray(X, dtype=np.float64)
    Z = np.ascontiguousarray(Z, dtype=np.float64)
    d = X.shape[1]
    ls = np.ascontiguousarray(np.broadcast_to(
        np.asarray(ls, dtype=np.float64).reshape(-1), (d,)))
    out = np.empty((X.shape[0], Z.shape[0]), dtype=np.float64)
    head = (_ptr(X), X.shape[0], _ptr(Z), Z.shape[0], d)
    if kind == "linear":
        rc = lib.gram_linear(*head, _ptr(ls), _ptr(out))
    elif kind == "poly":
        rc = lib.gram_poly(*head, float(var), float(scale), float(bias),
                           float(power), _ptr(out))
    elif kind == "mlp":
        rc = lib.gram_mlp(*head, _ptr(ls), float(var), float(bias),
                          _ptr(out))
    elif kind == "ratquad":
        rc = lib.gram_ratquad(*head, _ptr(ls), float(var), float(power),
                              _ptr(out))
    elif kind == "stdperiodic":
        T = np.ascontiguousarray(np.broadcast_to(
            np.asarray(period, dtype=np.float64).reshape(-1), (d,)))
        rc = lib.gram_stdperiodic(*head, _ptr(T), _ptr(ls), float(var),
                                  _ptr(out))
    else:
        fn = {"rbf": lib.gram_rbf, "matern32": lib.gram_matern32,
              "matern52": lib.gram_matern52,
              "exponential": lib.gram_exponential,
              "cosine": lib.gram_cosine}[kind]
        rc = fn(*head, _ptr(ls), float(var), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"native gram failed (rc={rc})")
    return out


def cholesky_lower(A: np.ndarray, n: int) -> None:
    """In-place lower Cholesky of A[:n, :n] (A row-major, square);
    ``LinAlgError`` at a non-positive pivot."""
    lib = _load()
    assert A.flags["C_CONTIGUOUS"] and A.dtype == np.float64
    rc = lib.cholesky_lower(_ptr(A), n, A.shape[1])
    if rc != 0:
        raise np.linalg.LinAlgError(
            f"matrix not positive definite at pivot {rc}")


def tri_inverse_lower(L: np.ndarray, n: int, out: np.ndarray) -> None:
    """out[:n, :n] = inv(L[:n, :n]) for lower-triangular L."""
    lib = _load()
    rc = lib.tri_inverse_lower(_ptr(L), n, L.shape[1], _ptr(out))
    if rc != 0:
        raise RuntimeError(f"native tri_inverse failed (rc={rc})")


def border_append(L: np.ndarray, Linv: np.ndarray, w: np.ndarray, pos: int,
                  kvec: np.ndarray, kxx_plus_noise: float, y: float) -> float:
    """Bordered Cholesky append at row ``pos`` of L, Linv and w in place;
    returns the new diagonal entry."""
    lib = _load()
    kvec = np.ascontiguousarray(kvec, dtype=np.float64)
    dd = ctypes.c_double(0.0)
    rc = lib.border_append(_ptr(L), _ptr(Linv), _ptr(w), pos, L.shape[1],
                           _ptr(kvec), float(kxx_plus_noise), float(y),
                           ctypes.byref(dd))
    if rc != 0:
        raise np.linalg.LinAlgError(
            f"native border_append failed (rc={rc})")
    return dd.value
