"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` are plain CUDA C++ with a C interface
(no PyTorch headers), compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source all started together, linked into
ONE shared library and loaded with ``ctypes``. The
library is cached under ``build/safeopt_torch/`` at the repository
root, keyed on a hash of the sources and flags, so an edited source
rebuilds. Nothing here runs at import time: a machine without ``nvcc``
imports the package and runs the plain PyTorch versions on the CPU.

A missing compiler or a failed build raises with nvcc's output; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

__all__ = ["library", "build_info", "build", "load", "sass_opcodes"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "safeopt_torch"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (pointers and the stream are
# c_void_p; a bare int argument would be cut to 32 bits)
_SIGNATURES = {
    "safeopt_intervals_f32": [_P] * 7 + [_I] * 5 + [_P],
    "safeopt_intervals_f64": [_P] * 7 + [_I] * 5 + [_P],
    "safeopt_intervals3_f32": [_P] * 7 + [_I] * 5 + [_P],
    "safeopt_intervals3_f64": [_P] * 7 + [_I] * 5 + [_P],
    "safeopt_expander_f32": [_P] * 11 + [_I] * 7 + [_P],
    "safeopt_expander_f64": [_P] * 11 + [_I] * 7 + [_P],
    "safeopt_intervals_plan_f32": [_P] * 9 + [_I] * 4 + [_P],
    "safeopt_intervals_plan_f64": [_P] * 9 + [_I] * 4 + [_P],
    "safeopt_intervals_plan3_f32": [_P] * 9 + [_I] * 4 + [_P],
    "safeopt_intervals_plan3_f64": [_P] * 9 + [_I] * 4 + [_P],
    "safeopt_expander_plan_f32": [_P] * 13 + [_I] * 5 + [_P],
    "safeopt_expander_plan_f64": [_P] * 13 + [_I] * 5 + [_P],
    "safeopt_intervals_launch_f32": [_P] * 7 + [_I] * 9 + [_P],
    "safeopt_intervals_launch_f64": [_P] * 7 + [_I] * 9 + [_P],
    "safeopt_interval_ablation_f32": [_P] * 7 + [_I] * 7 + [_P],
    "safeopt_interval_ablation_f64": [_P] * 7 + [_I] * 7 + [_P],
    "safeopt_intervals_mu_from_gram_f32": [_P] * 7 + [_I] * 6 + [_P],
    "safeopt_intervals_mu_from_gram_f64": [_P] * 7 + [_I] * 6 + [_P],
    "safeopt_intervals_split_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "safeopt_intervals_split_tf32": [_P] * 8 + [_I] * 5 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of safeopt_torch cannot be built")
    return found


def _sources(csrc: Path = _CSRC):
    return sorted(list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")))


def build(csrc: Path = _CSRC) -> Path:
    """Path of the kernel library built from the sources in ``csrc``,
    compiled unless cached."""
    sources = _sources(csrc)
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = _BUILD_DIR / f"libsafeopt_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        log = so.with_suffix(".log")
        _info.update(path=str(so), seconds=0.0, cached=True,
                     log=log.read_text() if log.exists() else "")
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    # build into a private directory, then rename the library: a process
    # building at the same time never loads a half-written one
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in sources if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, so)
    log = "".join(log)
    (so.with_suffix(".log")).write_text(log)
    _info.update(path=str(so), seconds=time.perf_counter() - start,
                 cached=False, log=log)
    return so


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library, loaded with its C signatures set."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.safeopt_error_string.argtypes = [ctypes.c_int]
    lib.safeopt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def sass_opcodes(opcode: str, path: Optional[Path] = None) -> dict:
    """``{kernel: count}`` of the SASS instructions whose opcode begins
    with ``opcode`` (``"HGMMA"``: Hopper's warpgroup tensor-core
    product) in each kernel of the library at ``path`` (default: the
    built one), from ``cuobjdump -sass``."""
    path = path or build()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):     # a predicate
                words = words[1:]
            if words and words[0].startswith(opcode):
                counts[name] += 1
    return counts


def build_info() -> dict:
    """Path, build seconds, cache hit and compiler log of the library
    (empty before the first ``library()`` call)."""
    return dict(_info)
