"""The paper's wire format (§3.1), written by the benchmark itself.

After dictionary replacement every tag is two symbols of a 64-character
alphabet: an open tag is the 4 bytes ``<xy>``, a close tag the 5 bytes
``</xy>``, and tag id ``i`` is written ``ALPHABET[i >> 6] ALPHABET[i &
63]``, ids taken in the order the deployment registers its tag names.
``text_fill`` filler bytes (``x``) follow each open tag as element text.
A frozen, vectorised copy of the port's ``core.events.encode_bytes``.
"""
from __future__ import annotations

import numpy as np

ALPHABET = ("abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
            "0123456789_.")
_SYM = np.frombuffer(ALPHABET.encode(), np.uint8)
OPEN_NBYTES, CLOSE_NBYTES = 4, 5


def encode(kind: np.ndarray, tag: np.ndarray, text_fill: int) -> bytes:
    """Event arrays (kind 0 open, 1 close) -> one wire payload."""
    kind = np.asarray(kind)
    tag = np.asarray(tag, np.int64)
    is_open = kind == 0
    size = np.where(is_open, OPEN_NBYTES + text_fill, CLOSE_NBYTES)
    start = np.concatenate(([0], np.cumsum(size)[:-1]))
    out = np.full(int(size.sum()), ord("x"), np.uint8)
    s0, s1 = _SYM[tag >> 6], _SYM[tag & 63]
    out[start] = ord("<")
    # open: < x y >   close: < / x y >
    sym = start + np.where(is_open, 1, 2)
    out[start[~is_open] + 1] = ord("/")
    out[sym] = s0
    out[sym + 1] = s1
    out[sym + 2] = ord(">")
    return out.tobytes()
