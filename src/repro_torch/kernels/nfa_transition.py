"""The levelwise NFA transition (K6): wrapper, plain version, count.

Counterpart of ``src/repro/kernels/nfa_transition.py``:
:func:`nfa_transition` advances W nodes over S states in one step,

    min(src * (onehot(tags) @ req + wild) + parent_rows * selfloop, 1)
        * (tags >= 0),    src[w, s] = parent_rows[w, parent_idx[s]]

in float32; replaces ``nfa_transition_pallas``.  The TPU kernel forms
``src`` as the product ``parent_rows @ parent_1h``; ``parent_1h`` has one
1 per column, at row ``in_state[s]``, so here ``src`` is the gather by
``parent_idx = in_state`` and every value equals the product's
(:func:`parent_index` turns a one-hot into that index).  The levelwise
engine runs it once per document level, the wavefront engine once per
chunk step, each for the whole batch at once.

On CUDA tensors it launches the hand-written kernel
(``csrc/nfa_transition.cu``, built and loaded by :mod:`.build`) and adds
one to ``nfa_transition.launches``; on CPU tensors it runs the plain
version, :func:`nfa_transition_plain`, the same gather written with
tensor ops.  There is no fallback from one to the other.  The kernel
masks ragged W and S edges itself, so, unlike the TPU kernel, it takes no
block sizes and the caller pads nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .launches import count_launch

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


def parent_index(parent_1h: torch.Tensor) -> torch.Tensor:
    """(S, S) parent one-hot → (S,) int32 ``parent_idx``, the row of each
    column's single 1.  Raises unless every column holds exactly one 1
    and zeros elsewhere, the form under which the gather equals the
    product."""
    if not isinstance(parent_1h, torch.Tensor) or parent_1h.dim() != 2 \
            or parent_1h.shape[0] != parent_1h.shape[1]:
        raise ValueError("parent_1h must be an (S, S) tensor")
    nonzero = parent_1h != 0
    per_col = nonzero.sum(0)
    bad = torch.nonzero(per_col != 1).flatten()
    if bad.numel():
        c = int(bad[0])
        raise ValueError(f"parent_1h column {c} holds {int(per_col[c])} "
                         f"nonzero entries, not one 1")
    idx = nonzero.to(torch.int8).argmax(0)
    ones = parent_1h.gather(0, idx[None, :])[0]
    if not bool((ones == 1).all()):
        c = int(torch.nonzero(ones != 1).flatten()[0])
        raise ValueError(f"parent_1h column {c} holds {float(ones[c])}, "
                         f"not 1")
    return idx.to(torch.int32)


def nfa_transition_plain(parent_rows: torch.Tensor, tags: torch.Tensor,
                         req: torch.Tensor, wild: torch.Tensor,
                         parent_idx: torch.Tensor, selfloop: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of :func:`nfa_transition`: the gather form, with
    :func:`ref.tag_rows` for ``onehot(tags) @ req``.  It equals
    :func:`ref.nfa_transition`, the product form, when ``parent_idx`` is
    :func:`parent_index` of its one-hot."""
    src = parent_rows.index_select(1, parent_idx.long())
    tagmatch = ref.tag_rows(tags, req) + wild[None, :]
    nxt = torch.clamp(src * tagmatch + parent_rows * selfloop[None, :],
                      max=1.0)
    return nxt * (tags >= 0)[:, None].to(nxt.dtype)


def nfa_transition(parent_rows: torch.Tensor, tags: torch.Tensor,
                   req: torch.Tensor, wild: torch.Tensor,
                   parent_idx: torch.Tensor, selfloop: torch.Tensor
                   ) -> torch.Tensor:
    """One level (or chunk) of W nodes → their (W, S) float32 0/1 states.

    parent_rows (W, S) float32, the parents' active sets; tags (W,) int32,
    -1 for a padding row (a tag ``>= T`` matches only wildcard states);
    req (T, S), wild (S,) float32; parent_idx (S,) int32, each state's
    parent state (the plan's ``in_state``), in [0, S); selfloop (S,)
    float32.
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
    _check(parent_idx, "parent_idx", torch.int32, (s,), dev)
    _check(selfloop, "selfloop", f32, (s,), dev)
    if dev.type == "cpu":
        return nfa_transition_plain(parent_rows, tags, req, wild, parent_idx,
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
    vec4 = s % 4 == 0 and all(
        x.data_ptr() % 16 == 0
        for x in (parent_rows, req, wild, parent_idx, selfloop, out))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nt_transition(
            _ptr(parent_rows), w, s, _ptr(tags), _ptr(req), t, _ptr(wild),
            _ptr(parent_idx), _ptr(selfloop), _ptr(out), int(vec4),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"nfa_transition launch failed: CUDA error {err}")
    count_launch(nfa_transition)
    return out


nfa_transition.launches = 0


def staged_max_states() -> int:
    """The most states a row may have for the kernel that stages parent
    rows in shared memory, on the current card (past it, the kernel reads
    parent values from device memory).  Needs the card."""
    from . import build

    return int(build.load("nfa_transition").nt_staged_max_states())
