"""Build the CUDA sources into a plain-C shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles ``csrc/stream_filter.cu`` into ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``) at first use; the library is
named by a hash of the source and flags, so an edited source rebuilds and
an unchanged one loads the existing file.  ``-Xptxas -v`` reports each
kernel's registers, shared memory and spills; the report is kept beside
the library (:func:`build_log`).  Loading binds every C entry point with
explicit ``argtypes``/``restype`` (``ctypes.c_void_p`` for pointers and
the stream).  Nothing here runs at import: this module imports on
machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "stream_filter.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_TABLES = [_P] * 7 + [_I] * 5          # tagmask .. acc_bit, G, T, WB, QB, depth
SIGNATURES = {
    "sf_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
    # events, B, N, tables, matched, first, stream
    "sf_events": ([_P, _I, _I] + _TABLES + [_P, _P, _P], ctypes.c_int),
    # data, S, L, starts, D, tables, matched, first, stream
    "sf_bytes": ([_P, _I, _I, _P, _I] + _TABLES + [_P, _P, _P],
                 ctypes.c_int),
}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$PATH``, else ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only where the toolkit is")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libstream_filter-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if this exact build is not there yet."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)          # atomic: a concurrent build never loads a torn file
    return lib


def build_log() -> str:
    """The ``-Xptxas -v`` report of the current build ("" before it)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
