"""Synthetic token pipeline for LM training (``repro.data.synthetic``,
near-verbatim: numpy, so its batches equal the reference's for a seed).

Deterministic, seedable, zipf-distributed token stream with enough local
structure (bigram mixing) that cross-entropy meaningfully decreases — the
e2e examples train against this.  Provides per-node heterogeneous shards
(each decentralized node gets a different bigram transition bias) to
exercise the paper's heterogeneity claims at the LM scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    node: int = 0
    num_nodes: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed + 7919 * self.node)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks**self.zipf_a
        self._probs = probs / probs.sum()
        # node-specific bigram shift: token t tends to be followed by
        # (t + shift) mod V — heterogeneous local distributions.
        self._shift = 1 + (self.node * 17) % max(1, self.vocab_size // 4)
        self._rng = rng

    def batches(self, n: int):
        for _ in range(n):
            yield self.next_batch()

    def next_batch(self):
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        base = self._rng.choice(V, size=(B, S), p=self._probs)
        # half the positions follow the bigram rule (learnable signal)
        follow = self._rng.random((B, S)) < 0.5
        shifted = np.roll(base, 1, axis=1)
        tokens = np.where(follow, (shifted + self._shift) % V, base)
        tokens[:, 0] = base[:, 0]
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        return {
            "tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32),
        }


def node_streams(m: int, vocab_size: int, seq_len: int, batch_size: int, seed=0):
    return [
        TokenStream(vocab_size, seq_len, batch_size, seed=seed, node=i, num_nodes=m)
        for i in range(m)
    ]
