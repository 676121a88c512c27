"""The character pre-decoder (K5): wrapper, plain version, count.

Counterpart of ``src/repro/kernels/predecode.py``: :func:`predecode`
classifies every byte position of a ``(B, L)`` (or ``(L,)``) uint8 batch
into ``(kind, tag)`` int32 from its byte and the three after it in the
same row, zeros past the row's end; replaces ``predecode_pallas``.

On CUDA tensors it launches the hand-written kernel
(``csrc/predecode.cu``, built and loaded by :mod:`.build`) and adds one
to ``predecode.launches``; on CPU tensors it runs the plain version,
:func:`repro_torch.kernels.ref.predecode`.  There is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref


def predecode(bytes_: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., L) uint8 → same-shaped (kind int32, tag int32); PAD and -1
    where no tag starts."""
    if not isinstance(bytes_, torch.Tensor) or bytes_.dtype != torch.uint8:
        raise TypeError("predecode takes a torch.uint8 tensor")
    dev = bytes_.device
    if bytes_.dim() < 1:
        raise ValueError("predecode needs at least one (byte) axis")
    if dev.type == "cpu":
        return ref.predecode(bytes_)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    from . import build

    lib = build.load("predecode")
    length = bytes_.shape[-1]
    data = bytes_.reshape(-1, length).contiguous()
    rows = data.shape[0]
    kind = torch.empty(bytes_.shape, dtype=torch.int32, device=dev)
    tag = torch.empty(bytes_.shape, dtype=torch.int32, device=dev)
    if rows == 0 or length == 0:
        return kind, tag
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pd_predecode(
            ctypes.c_void_p(data.data_ptr()), rows, length,
            ctypes.c_void_p(kind.data_ptr()), ctypes.c_void_p(tag.data_ptr()),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"predecode launch failed: CUDA error {err}")
    predecode.launches += 1
    return kind, tag


predecode.launches = 0
