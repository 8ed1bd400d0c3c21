"""Build the port's CUDA kernels and bind them with ctypes.

Each csrc/*.cu is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu
    nvcc -shared -o <lib> <objects>

The library lands in lastz_tpu_torch/build/, named by a hash of the
sources and flags (the way native/__init__.py caches its g++ build),
so a changed source rebuilds and an unchanged one loads at once.  The
build runs at first use, never at import: the CPU tests import every
module on a machine without nvcc.  ptxas's register and shared-memory
report goes to a .log file beside the library.

Each C entry point returns the launch's cudaGetLastError() code; the
wrappers raise when it is not 0, and count the launch with count().
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
_COUNT_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "ydrop_chunk_launch": [_P] * 11 + [_LL] + [_I] * 9 + [_P],
    "ydrop_mega_launch": [_P, _I, _P, _I] + [_P] * 15 + [_I] + [_P] * 4
                         + [_I] * 9 + [_P],
    "ydrop_traceback_launch": [_P] * 11 + [_I] * 5 + [_P],
    "xdrop_scan_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _LL,
                          _P, _P, _P, _P],
    "xdrop_scan_wide_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _LL,
                               _P, _P, _P, _P],
    "ydrop_wavefront_launch": [_P] * 5 + [_I] * 3 + [_P],
    "ydrop_band_launch": [_P] * 5 + [_I] * 3 + [_P],
    "resolve_chains_launch": [_P, _P, _I] + [_P] * 6 + [_I] * 3
                             + [_P] * 5,
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME)")
    return found


def library_path() -> str:
    """Path of the built library, building it first if needed."""
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"liblastz_kernels_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o",
             f"{tmp}.{os.path.basename(cu)}.o", cu]
            for cu in sources() if cu.endswith(".cu")]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    link = [nvcc, "-shared", "-o", tmp, *(c[-2] for c in cmds)]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outs.append((proc.stdout, proc.stderr))
        if proc.returncode != 0:
            failed.append((link, proc.returncode, outs[-1]))
    with open(os.path.join(BUILD_DIR, f"liblastz_kernels_{tag}.log"),
              "w") as f:
        for c, (out, err) in zip(cmds + [link], outs):
            f.write(" ".join(c) + "\n" + out + err)
    for c in cmds:
        if os.path.exists(c[-2]):
            os.remove(c[-2])
    if failed:
        c, rc, (_, err) = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {c[-1]}:\n{err[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(library_path())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def count(fn, counter: str = "launches", **more) -> None:
    """fn.<counter> += 1 (a wrapper's launch of its kernel), and each of
    `more`'s counters of fn by its value, under one lock: the farm's
    workers launch from several threads at once."""
    with _COUNT_LOCK:
        setattr(fn, counter, getattr(fn, counter) + 1)
        for name, n in more.items():
            setattr(fn, name, getattr(fn, name) + n)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
