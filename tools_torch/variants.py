"""Patched builds of the kernel sources, shared by the tools that time
variants of a kernel (``tune_gram_rows.py``, ``tune_intervals.py``,
``tune_three_pass.py``, ``tune_tiled.py``).

A variant is a copy of ``safeopt_torch/ops/csrc`` (or of another tree's)
under ``build/`` with some text replaced (``patched_copy``). The tools
build some of its ``.cu`` files into one shared library with the
package's nvcc flags, one ``nvcc`` a variant and all started together
(``build_all``), and hand the library's C entries to the package's
wrappers (``load_entries``, set as ``_build._lib``), so that the
wrappers launch the variant. ``ptxas_usage`` reads the registers and
spills of each instance from nvcc's log. Nothing here needs a card but
``build_all``, which needs ``nvcc``.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path


def patched_copy(dst, patches, csrc=None, skip_missing=False):
    """``dst``: a copy of ``csrc`` (default: the package's sources) with
    each ``(file, old, new)`` of ``patches`` applied, ``old`` a string or
    a tuple of alternatives of which the first found is replaced. A patch
    whose text is not found raises ``ValueError``. With ``skip_missing``
    a patch whose file the copy lacks is skipped (a tree from before the
    file), and ``ValueError`` is raised only if patches were given and
    none applied."""
    from safeopt_torch.ops import _build

    dst, csrc = Path(dst), Path(csrc or _build._CSRC)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    applied = 0
    for fname, old, new in patches:
        path = dst / fname
        if skip_missing and not path.exists():
            continue
        text = path.read_text()
        found = [o for o in (old if isinstance(old, tuple) else (old,))
                 if o in text]
        if not found:
            raise ValueError(f"{dst.name}: patch not found in {fname}: "
                             f"{old!r}")
        path.write_text(text.replace(found[0], new))
        applied += 1
    if patches and not applied:
        raise ValueError(f"{dst.name}: no patch applies to {csrc}")
    return dst


def build_all(jobs):
    """``{name: (library path or None, nvcc's log)}`` of ``jobs``
    (``{name: (patched copy, [.cu files of it])}``): each job's files
    built into ``lib.so`` in its copy with the package's flags, one
    ``nvcc`` a job, all started together."""
    from safeopt_torch.ops import _build

    procs = {}
    for name, (src, files) in jobs.items():
        so = Path(src) / "lib.so"
        cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so),
               *(str(Path(src) / f) for f in files)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        out[name] = (so if proc.returncode == 0 else None, log)
    return out


def load_entries(so, names):
    """A stand-in for the package's library: the C entries ``names`` of
    the library at ``so``, typed as ``_build._SIGNATURES`` types them,
    and ``safeopt_error_string`` (the library's own, or a stand-in where
    the files built do not define it)."""
    from safeopt_torch.ops import _build

    lib = ctypes.CDLL(str(so))
    ns = types.SimpleNamespace()
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        setattr(ns, name, fn)
    try:
        err = lib.safeopt_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    except AttributeError:
        def err(code):
            return f"no error strings in {Path(so).parent.name}".encode()
    ns.safeopt_error_string = err
    return ns


def ptxas_usage(log):
    """``{kernel: "N registers, M bytes spill stores"}`` of every kernel
    instance, from nvcc's ``-Xptxas -v`` log."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "Used" in line:
            usage[name] = line.split(":", 1)[1].strip()
        elif name and "spill" in line:
            usage[name + " spills"] = line.strip()
    return usage
