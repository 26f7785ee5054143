"""Heterogeneous data partitioning across decentralized nodes.

The paper's non-iid setting: a fraction ``h`` of each class's samples is
assigned to that class's "home" node, the remainder is spread uniformly.
h = 0 -> iid random split; h = 0.8 matches the paper's experiments.
"""

from __future__ import annotations

import numpy as np


def label_skew_partition(
    labels: np.ndarray, m: int, h: float, seed: int = 0
) -> list[np.ndarray]:
    """Return per-node index arrays (equal sizes, truncated to the minimum)."""
    rng = np.random.default_rng(seed)
    buckets: list[list[int]] = [[] for _ in range(m)]
    classes = np.unique(labels)
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        home = int(c) % m
        n_home = int(round(h * len(idx)))
        buckets[home].extend(idx[:n_home].tolist())
        rest = idx[n_home:]
        for pos, j in enumerate(rest):
            buckets[(home + 1 + pos) % m].append(int(j))
    sizes = [len(b) for b in buckets]
    n_min = min(sizes)
    out = []
    for b in buckets:
        arr = np.asarray(b)
        rng.shuffle(arr)
        out.append(arr[:n_min])
    return out


def stack_shards(arrays: np.ndarray, shards: list[np.ndarray]) -> np.ndarray:
    """Gather rows per shard and stack to node-major layout (m, n_min, ...)."""
    return np.stack([arrays[s] for s in shards], axis=0)
