# Copy of src/repro/core/dictionary.py (the port imports nothing of the JAX package).
"""Dictionary replacement (§3.1 of the paper).

XML tags in both the documents and the profiles are replaced by *fixed
length* two-symbol strings so that every open tag occupies exactly 32 bits
(``<`` + 2 symbols + ``>``) and every close tag exactly 40 bits
(``</`` + 2 symbols + ``>``) on the wire.  Fixed-length tags are what make
the byte stream *parallel-decodable* — the property our TPU pre-decode
kernel (and the paper's character pre-decoder) relies on.

The symbol alphabet is 64 characters (``a-z A-Z 0-9 _ .``) giving 4096
distinct tags per dictionary, far more than any evaluated profile set.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np

ALPHABET = (
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "0123456789_."
)
assert len(ALPHABET) == 64
_CHAR_TO_VAL = {c: i for i, c in enumerate(ALPHABET)}

MAX_TAGS = 64 * 64

OPEN_NBYTES = 4    # '<'  s0 s1 '>'   = 32 bits  (paper §3.1)
CLOSE_NBYTES = 5   # '<' '/' s0 s1 '>' = 40 bits

LT, GT, SLASH = ord("<"), ord(">"), ord("/")


class DictionaryFull(ValueError):
    pass


@dataclass
class TagDictionary:
    """Bidirectional tag-name ⇄ fixed-length-symbol-id mapping."""

    tag_to_id: dict[str, int] = field(default_factory=dict)
    id_to_tag: list[str] = field(default_factory=list)

    # ------------------------------------------------------------- building
    @classmethod
    def build(cls, tags: Iterable[str]) -> "TagDictionary":
        d = cls()
        for t in tags:
            d.add(t)
        return d

    def add(self, tag: str) -> int:
        if tag in self.tag_to_id:
            return self.tag_to_id[tag]
        if len(self.id_to_tag) >= MAX_TAGS:
            raise DictionaryFull(f"dictionary limited to {MAX_TAGS} tags")
        tid = len(self.id_to_tag)
        self.tag_to_id[tag] = tid
        self.id_to_tag.append(tag)
        return tid

    def __len__(self) -> int:
        return len(self.id_to_tag)

    def __contains__(self, tag: str) -> bool:
        return tag in self.tag_to_id

    def lookup(self, tag: str) -> int:
        return self.tag_to_id[tag]

    # ------------------------------------------------- symbol-level codecs
    @staticmethod
    def symbols_of(tid: int) -> str:
        """The two-symbol replacement string for a tag id (e.g. 0 → 'aa')."""
        return ALPHABET[tid >> 6] + ALPHABET[tid & 63]

    @staticmethod
    def id_of_symbols(sym: str) -> int:
        return (_CHAR_TO_VAL[sym[0]] << 6) | _CHAR_TO_VAL[sym[1]]

    def open_bytes(self, tid: int) -> bytes:
        return b"<" + self.symbols_of(tid).encode() + b">"

    def close_bytes(self, tid: int) -> bytes:
        return b"</" + self.symbols_of(tid).encode() + b">"

    # --------------------------------------------------- vectorised tables
    def symbol_value_table(self) -> np.ndarray:
        """(256,) int32: byte value → symbol value, -1 for non-alphabet."""
        table = np.full(256, -1, dtype=np.int32)
        for c, v in _CHAR_TO_VAL.items():
            table[ord(c)] = v
        return table

    def rewrite_profile_tags(self, queries) -> list:
        """Dictionary-replace tag names inside parsed queries (→ new Query list).

        Mirrors the paper's step 1: profiles and documents are rewritten to
        the fixed-length encoding *before* regex generation.
        """
        from .xpath import Query, Step, WILDCARD

        out = []
        for q in queries:
            steps = tuple(
                Step(s.axis, s.tag if s.tag == WILDCARD else self.symbols_of(self.add(s.tag)))
                for s in q.steps
            )
            out.append(Query(steps, q.raw))
        return out


def symbol_values(dictionary: Mapping[str, int] | TagDictionary) -> np.ndarray:
    if isinstance(dictionary, TagDictionary):
        return dictionary.symbol_value_table()
    raise TypeError(type(dictionary))
