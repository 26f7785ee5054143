"""The benchmark's one generator of inputs: every cell's traffic file is
data that this module reads.

A C²DFB cell is a closed loop of outer rounds.  Its traffic is the
algorithm's settings (the compressor, the inner steps K), the graph of
nodes, and, for an LM, each node's token batch: ``batch`` sequences of
``seq_len`` tokens a node and level, drawn as the reference launcher's
synthetic streams draw them: Zipf-distributed tokens (exponent
``zipf_a``), a fraction ``follow`` of the positions following the node's
own bigram rule t -> t + shift(node) mod V, the labels the next tokens
(the last 0).  The training tokens come from the seed, the validation
tokens from the seed + 1; node i's stream from seed + 7919 i.
"""

from __future__ import annotations

import numpy as np


def node_tokens(vocab: int, batch: int, seq_len: int, seed: int, node: int, zipf_a: float,
                follow: float) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed + 7919 * node)
    probs = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** zipf_a
    probs /= probs.sum()
    shift = 1 + (node * 17) % max(1, vocab // 4)
    base = rng.choice(vocab, size=(batch, seq_len), p=probs)
    follows = rng.random((batch, seq_len)) < follow
    tokens = np.where(follows, (np.roll(base, 1, axis=1) + shift) % vocab, base)
    tokens[:, 0] = base[:, 0]
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return tokens.astype(np.int32), labels.astype(np.int32)


def token_shards(vocab: int, traffic: dict, m: int, seed: int) -> dict:
    """{"train": {"tokens", "labels"}, "val": {...}}: (m, batch, seq_len)
    int32 arrays."""
    out = {}
    for level, s in (("train", seed), ("val", seed + 1)):
        pairs = [node_tokens(vocab, traffic["batch"], traffic["seq_len"], s, i, traffic["zipf_a"],
                             traffic["follow"]) for i in range(m)]
        out[level] = {"tokens": np.stack([p[0] for p in pairs]), "labels": np.stack([p[1] for p in pairs])}
    return out
