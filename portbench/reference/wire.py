"""Decode a wire payload into element events, for the reference.

The format is the paper's (§3.1): ``<xy>`` opens and ``</xy>`` closes the
element whose tag id is ``64 * v(x) + v(y)``, ``v`` the position of a
symbol in the 64-character alphabet; any other byte is element text.
"""
from __future__ import annotations

import numpy as np

ALPHABET = ("abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
            "0123456789_.")
_VALUE = np.full(256, -1, np.int64)
_VALUE[np.frombuffer(ALPHABET.encode(), np.uint8)] = np.arange(64)


def symbols(tag_id: int) -> str:
    """The two-symbol code of a tag id."""
    return ALPHABET[tag_id >> 6] + ALPHABET[tag_id & 63]


def decode(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """``(is_open, tag)`` of every tag marker, in document order.

    Raises ``ValueError`` on a marker that is not a whole, well-formed tag
    of the alphabet: the benchmark's payloads have none, and the
    reference must not guess.
    """
    b = np.frombuffer(payload, np.uint8)
    n = b.shape[0]
    lt = np.flatnonzero(b == ord("<"))
    if lt.size == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64)
    pad = np.concatenate([b, np.zeros(5, np.uint8)])
    close = pad[lt + 1] == ord("/")
    first = lt + np.where(close, 2, 1)
    v0, v1 = _VALUE[pad[first]], _VALUE[pad[first + 1]]
    ok = (v0 >= 0) & (v1 >= 0) & (pad[first + 2] == ord(">"))
    ok &= first + 2 < n
    if not ok.all():
        at = int(lt[np.flatnonzero(~ok)[0]])
        raise ValueError(f"malformed tag marker at byte {at}")
    return ~close, v0 * 64 + v1
