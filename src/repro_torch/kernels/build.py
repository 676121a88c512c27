"""Build the CUDA sources into plain-C shared libraries and load them.

Each source in ``csrc/`` (:data:`SOURCES`) is compiled on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``) at first use; all the builds a call needs start together
and run in parallel.  A library is named by a hash of its source and the
flags, so an edited source rebuilds and an unchanged one loads the
existing file.  ``-Xptxas -v`` reports each kernel's registers, shared
memory and spills; the report is kept beside the library
(:func:`build_log`).  Loading binds every C entry point with explicit
``argtypes``/``restype`` (``ctypes.c_void_p`` for pointers and the
stream).  Nothing here runs at import: this module imports on machines
with no ``nvcc`` and no card.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_TABLES = [_P] * 7 + [_I] * 5          # tagmask .. acc_bit, G, T, WB, QB, depth
_SPARSE = [_P, _I, _P, _P]             # lane_cls, cap, buf, count
#: C entry points of each library (by source stem)
SIGNATURES = {
    "stream_filter": {
        # n_tags, WB, QB, max_depth, sparse, bytes
        "sf_smem_bytes": ([_I] * 6, ctypes.c_longlong),
        "sf_max_slots": ([], ctypes.c_int),
        # G, n_tags, WB
        "sf_scratch_words": ([_I] * 3, ctypes.c_longlong),
        # events, B, N, tables, matched, first, scratch, stream
        "sf_events": ([_P, _I, _I] + _TABLES + [_P, _P, _P, _P],
                      ctypes.c_int),
        # events, B, N, doc_ids, tables, lane_cls, cap, buf, count,
        # scratch, stream
        "sf_events_sparse": ([_P, _I, _I, _P] + _TABLES + _SPARSE
                             + [_P, _P], ctypes.c_int),
        # data, S, L, starts, D, tables, matched, first, scratch, stream
        "sf_bytes": ([_P, _I, _I, _P, _I] + _TABLES + [_P, _P, _P, _P],
                     ctypes.c_int),
        # data, S, L, starts, D, doc_map, tables, lane_cls, cap, buf,
        # count, scratch, stream
        "sf_bytes_sparse": ([_P, _I, _I, _P, _I, _P] + _TABLES + _SPARSE
                            + [_P, _P], ctypes.c_int),
    },
    "predecode": {
        # data, rows, L, kind, tag, stream
        "pd_predecode": ([_P, _I, _I, _P, _P, _P], ctypes.c_int),
    },
    "nfa_transition": {
        # parent_rows, W, S, tags, req, T, wild, parent_idx, selfloop, out,
        # vec4, stream
        "nt_transition": ([_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P],
                          ctypes.c_int),
        "nt_staged_max_states": ([], ctypes.c_int),
    },
}
SOURCES = tuple(CSRC / f"{name}.cu" for name in SIGNATURES)


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


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] | None = None) -> dict[str, Path]:
    """Compile every named source (default: all) that is not built yet,
    one ``nvcc`` each, all started together."""
    names = tuple(SIGNATURES) if names is None else names
    todo = {n: library_path(n) for n in names}
    running = []
    for name, lib in todo.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running.append((lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for lib, tmp, cmd, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)      # atomic: a concurrent build never loads a torn file
    if failed:
        raise RuntimeError("\n".join(failed))
    return todo


def build_log() -> str:
    """The ``-Xptxas -v`` reports of the current builds ("" before)."""
    logs = [library_path(n).with_suffix(".log") for n in SIGNATURES]
    return "".join(p.read_text() for p in logs if p.exists())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    for fn_name, (argtypes, restype) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
