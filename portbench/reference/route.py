"""Where the reference delivers a document: each destination shard that
holds a subscription the document matches, with the matching global
profile ids of that shard.  Profile ``g`` lives on shard ``g %
n_shards`` (round-robin placement)."""
from __future__ import annotations

import numpy as np


def deliveries(matched: np.ndarray, n_shards: int) -> dict[int, np.ndarray]:
    """Shard -> sorted global profile ids, for the shards that get the
    document (an unmatched document goes nowhere)."""
    matched = np.sort(np.asarray(matched, np.int64))
    shard = matched % n_shards
    return {int(s): matched[shard == s] for s in np.unique(shard)}
