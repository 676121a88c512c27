# Copy of src/repro/checkpoint/store.py:46-121 and :225-277 (the port imports
# nothing of the JAX package), with PlanCache.load added; CheckpointStore
# (:123-223) ported over the port's own pytrees and placed trees.
"""Checkpoints and the crash-safe plan cache of the port.

Layout per entry::

    <dir>/step_000123/   or   <dir>/plan_<key>/
        manifest.json    # keys, shapes, dtypes (a step: step, config)
        arrays.npz       # one entry per leaf / plan table
    <dir>/LATEST         # a checkpoint's atomically updated pointer

Entry contents are fsynced, the entry directory is written as
``<name>.tmp`` then ``os.rename``\\ d (POSIX atomic), and a pointer goes
through an fsynced temp file and ``os.replace``: a crash at any point
leaves the old entry or the new one, never a torn entry.

:class:`CheckpointStore` keeps training state (any tree of tensors,
such as ``(params, opt_state)``).  Its format is the JAX store's byte for
byte: the keys are the leaves' paths in JAX's leaf order
(:mod:`repro_torch.tree`: ``"0/embed"``, ``"1/m/3"``), the arrays
numpy's, the manifest's fields the same, so a step written by either
package restores in the other.  ``restore_latest`` walks back to the
newest intact step.  ``save_async`` copies every leaf to host memory
before it returns (the port's optimizer updates parameters in place),
then writes on a thread.  ``restore(step, like, shardings)`` places each
leaf on a mesh's positions as the JAX store does (elastic restore: a step
saved under one layout restores under another), and ``save`` gathers a
placed leaf first, so the files never depend on the layout;
``restore(..., device=)`` puts the leaves on one device.

A bfloat16 leaf is stored as the JAX store stores it: numpy has no
bfloat16, so the npz holds its 2 raw bytes an element (dtype ``|V2``)
and the manifest says ``"bfloat16"``.  ``restore`` reads ``|V2`` (or
uint16) back as bfloat16 wherever ``like``'s leaf is bfloat16.  The JAX
store's own ``restore`` hands back the ``|V2`` arrays; the port does not
copy that.

:class:`PlanCache` keeps compiled filter-plan tables under a content hash
(:meth:`repro_torch.core.engines.base.FilterEngine.plan_cache_key`), so a
cold start or a crash recovery skips the compile.  A torn or unreadable
entry reads as a miss and is overwritten by the next ``put``.  The port
adds :meth:`PlanCache.load`, a ``get`` whose caller may refuse an entry
(the engines rebuild a hit through the table checks of
:mod:`repro_torch.convert`; an entry they refuse counts as a miss).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, TypeVar

import numpy as np
import torch

from ..sharding.placement import PlacedTensor, device_put, gather
from ..tree import key_of, tree_flatten_with_path, tree_map_with_path

T = TypeVar("T")


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    # directory fsync makes the rename itself durable; some filesystems
    # refuse O_RDONLY on dirs — degrading to no-sync there is still no
    # worse than the pre-hardening behavior
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def _write_entry(directory: str, name: str, flat: dict[str, np.ndarray],
                 manifest: dict) -> str:
    """Crash-safe entry write shared by checkpoints and the plan cache.

    ``<dir>/<name>.tmp/{arrays.npz, manifest.json}`` is written, each
    file fsynced (manifest last, so a readable manifest implies readable
    arrays), then the directory atomically renamed to ``<dir>/<name>``
    and the parent directory fsynced — the entry either exists intact or
    not at all.
    """
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    _fsync_file(os.path.join(tmp, "arrays.npz"))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(directory)
    return final


def _write_pointer(directory: str, pointer: str, value: str) -> None:
    """Atomically (re)point ``<dir>/<pointer>`` at ``value`` via an
    fsynced temp file + ``os.replace`` — a crash can never leave the
    pointer missing or half-written."""
    tmp = os.path.join(directory, pointer + ".tmp")
    with open(tmp, "w") as f:
        f.write(value)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, pointer))
    _fsync_dir(directory)


def _valid_entry(path: str) -> bool:
    """Entry intact: manifest readable and every key present in the npz."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return sorted(z.files) == sorted(manifest["keys"])
    except Exception:
        return False


#: numpy's stand-in for bfloat16 in an npz: 2 raw bytes an element
_BF16_NPZ = np.dtype("V2")


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy copy (a copy even of a CPU tensor, so later
    in-place updates leave it alone); bfloat16 as its raw bytes."""
    if isinstance(leaf, PlacedTensor):
        leaf = gather(leaf, "cpu")
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(_BF16_NPZ)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype, as JAX's ``str(v.dtype)`` spells it."""
    return "bfloat16" if arr.dtype == _BF16_NPZ else str(arr.dtype)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    """Every leaf as a host numpy copy under its JAX key path."""
    return {key_of(path): _host(leaf)
            for path, leaf in tree_flatten_with_path(tree)}


def _tensor(arr: np.ndarray, dtype: torch.dtype | None) -> torch.Tensor:
    if dtype == torch.bfloat16 and arr.dtype in (_BF16_NPZ, np.uint16):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _tree_like(tree: Any, flat: dict[str, np.ndarray], device) -> Any:
    def leaf(path, like):
        key = key_of(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        dev = device if device is not None else getattr(like, "device",
                                                        "cpu")
        return _tensor(arr, getattr(like, "dtype", None)).to(dev)
    return tree_map_with_path(leaf, tree)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- saving
    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        flat = _flatten(tree)
        return self._write(step, flat, extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        self.wait()  # at most one outstanding write
        flat = _flatten(tree)  # snapshot synchronously (device → host)
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, extra or {}), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict) -> str:
        name = f"step_{step:08d}"
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
            **extra,
        }
        final = _write_entry(self.dir, name, flat, manifest)
        _write_pointer(self.dir, "LATEST", name)
        self._gc()
        return final

    def _steps(self) -> list[str]:
        return sorted(d for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def _gc(self) -> None:
        for d in self._steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ------------------------------------------------------------ restore
    def latest_step(self) -> int | None:
        for name in reversed(self._steps()):
            if _valid_entry(os.path.join(self.dir, name)):
                return int(name.split("_")[1])
        return None

    def restore(self, step: int, like: Any, shardings: Any | None = None,
                device: Any | None = None) -> tuple[Any, dict]:
        """The step's tree in ``like``'s structure, each leaf checked
        against ``like``'s shape, and its manifest.

        With ``shardings`` (a :class:`~repro_torch.sharding.placement.
        NamedSharding` tree of ``like``'s structure, or one for every
        leaf) each leaf is placed on its mesh's positions
        (:func:`~repro_torch.sharding.placement.device_put`), whatever
        layout the step was saved from.  Otherwise it goes to ``device``
        (``None``: the device of ``like``'s leaf)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        if shardings is None:
            return _tree_like(like, flat, device), manifest
        host = _tree_like(like, flat, "cpu" if device is None else device)
        return device_put(host, shardings), manifest

    def restore_latest(self, like: Any, shardings: Any | None = None,
                       device: Any | None = None):
        step = self.latest_step()
        if step is None:
            return None
        tree, manifest = self.restore(step, like, shardings, device)
        return step, tree, manifest


# ------------------------------------------------------------- plan cache
class PlanCache:
    """Crash-safe persisted cache of compiled filter-plan tables.

    Layout: one entry per key under ``<dir>/plan_<key>/`` with the same
    ``{arrays.npz, manifest.json}`` format — and the same fsync +
    atomic-rename write path (:func:`_write_entry`) — as a checkpoint
    step, so a crash mid-``put`` leaves either the old entry or the new
    one, never a torn cache.  Keys are opaque content hashes (the engine
    layer derives them from NFA tables × pad targets × kernel config,
    :meth:`repro_torch.core.engines.base.FilterEngine.plan_cache_key`), so a
    stale hit is structurally impossible: different inputs hash to a
    different entry.

    ``hits``/``misses`` count lookups for the cold-start benchmarks and
    the cache-hit tests; a corrupt entry reads as a miss (and is
    overwritten by the next ``put``), mirroring ``restore_latest``'s
    walk-back semantics.
    """

    def __init__(self, directory: str) -> None:
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"plan_{key}")

    def __contains__(self, key: str) -> bool:
        return _valid_entry(self._path(key))

    def get(self, key: str) -> tuple[dict[str, np.ndarray], dict] | None:
        """→ ``(tables, manifest)`` or ``None`` (miss/corrupt entry)."""
        d = self._path(key)
        if not _valid_entry(d):
            self.misses += 1
            return None
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            tables = {k: z[k] for k in z.files}
        self.hits += 1
        return tables, manifest

    def load(self, key: str,
             build: Callable[[dict[str, np.ndarray], dict], T]) -> T | None:
        """``build(tables, manifest)`` of the entry under ``key``, or
        ``None`` on a miss.  An entry that ``build`` refuses with a
        ``ValueError`` (tables that fail their checks) is a miss as a torn
        entry is: counted with the misses, and overwritten by the next
        ``put``."""
        hit = self.get(key)
        if hit is None:
            return None
        try:
            return build(*hit)
        except ValueError:
            self.hits -= 1
            self.misses += 1
            return None

    def put(self, key: str, tables: dict[str, np.ndarray],
            extra: dict | None = None) -> str:
        flat = {k: np.asarray(v) for k, v in tables.items()}
        manifest = {"keys": sorted(flat), **(extra or {})}
        return _write_entry(self.dir, f"plan_{key}", flat, manifest)

    def keys(self) -> list[str]:
        return sorted(d[len("plan_"):] for d in os.listdir(self.dir)
                      if d.startswith("plan_") and not d.endswith(".tmp"))
