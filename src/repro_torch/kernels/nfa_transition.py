"""The levelwise NFA transition (K6): wrapper, plain version, count.

Counterpart of ``src/repro/kernels/nfa_transition.py``:
:func:`nfa_transition` advances W nodes over S states in one step,

    min((parent_rows @ parent_1h) * (onehot(tags) @ req + wild)
        + parent_rows * selfloop, 1) * (tags >= 0)

in float32; replaces ``nfa_transition_pallas``.  The levelwise engine
runs it once per document level, the wavefront engine once per chunk
step, each for the whole batch at once.

On CUDA tensors it launches the hand-written kernel
(``csrc/nfa_transition.cu``, built and loaded by :mod:`.build`) and adds
one to ``nfa_transition.launches``; on CPU tensors it runs the plain
version, :func:`repro_torch.kernels.ref.nfa_transition`.  There is no
fallback from one to the other.  The kernel masks ragged W and S edges
itself, so, unlike the TPU kernel, it takes no block sizes and the
caller pads nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

_INT32_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple[int, ...], device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def nfa_transition(parent_rows: torch.Tensor, tags: torch.Tensor,
                   req: torch.Tensor, wild: torch.Tensor,
                   parent_1h: torch.Tensor, selfloop: torch.Tensor
                   ) -> torch.Tensor:
    """One level (or chunk) of W nodes → their (W, S) float32 0/1 states.

    parent_rows (W, S) float32, the parents' active sets; tags (W,) int32,
    -1 for a padding row (a tag ``>= T`` matches only wildcard states);
    req (T, S), wild (S,), parent_1h (S, S), selfloop (S,) float32.
    """
    if not isinstance(parent_rows, torch.Tensor) or parent_rows.dim() != 2:
        raise ValueError("parent_rows must be a (W, S) tensor")
    dev = parent_rows.device
    w, s = parent_rows.shape
    if not isinstance(req, torch.Tensor) or req.dim() != 2:
        raise ValueError("req must be a (T, S) tensor")
    t = req.shape[0]
    f32 = torch.float32
    _check(parent_rows, "parent_rows", f32, (w, s), dev)
    _check(tags, "tags", torch.int32, (w,), dev)
    _check(req, "req", f32, (t, s), dev)
    _check(wild, "wild", f32, (s,), dev)
    _check(parent_1h, "parent_1h", f32, (s, s), dev)
    _check(selfloop, "selfloop", f32, (s,), dev)
    if dev.type == "cpu":
        return ref.nfa_transition(parent_rows, tags, req, wild, parent_1h,
                                  selfloop)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if max(w, s, t) > _INT32_MAX:
        raise ValueError(f"(W, S, T) = {(w, s, t)} do not fit the kernel's "
                         f"int arguments")
    from . import build

    lib = build.load("nfa_transition")
    out = torch.empty((w, s), dtype=f32, device=dev)
    if w == 0 or s == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nt_transition(
            _ptr(parent_rows), w, s, _ptr(tags), _ptr(req), t, _ptr(wild),
            _ptr(parent_1h), _ptr(selfloop), _ptr(out),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"nfa_transition launch failed: CUDA error {err}")
    nfa_transition.launches += 1
    return out


nfa_transition.launches = 0
