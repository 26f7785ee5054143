"""Replay the JAX reference's random draws into the PyTorch port.

The port's stochastic compressors draw from an explicit random source in
the order of the reference's key tree (``repro_torch.core.compression``).
``JaxReplay`` is such a source: it is handed the reference's per-leaf keys
in that order (the ``*_leaf_keys`` walkers below), splits each into the m
per-node keys as ``compress_stacked`` does, and draws with ``jax.random``
exactly what each node's compressor draws.
"""

import jax
import numpy as np
import torch


class JaxReplay:
    def __init__(self, leaf_keys, m: int):
        self._leaf_keys = iter(leaf_keys)
        self.m = m
        self._node_keys: list = []
        self.draws = 0

    def _next_node_keys(self):
        return list(jax.random.split(next(self._leaf_keys), self.m))

    def uniform(self, shape, device):
        assert not self._node_keys, "a uniform draw inside a leaf of choice draws"
        per = int(np.prod(shape)) // self.m
        u = np.concatenate([np.asarray(jax.random.uniform(k, (per,))) for k in self._next_node_keys()])
        self.draws += 1
        return torch.from_numpy(u.reshape(shape)).to(device)

    def choice(self, n, k, device):
        if not self._node_keys:
            self._node_keys = self._next_node_keys()
            self.draws += 1
        key = self._node_keys.pop(0)
        idx = np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))
        return torch.from_numpy(idx.astype(np.int64)).to(device)


def message_leaf_keys(key, n_leaves: int):
    """One compress_stacked call: its per-leaf keys."""
    return list(jax.random.split(key, n_leaves))


def inner_loop_leaf_keys(key, K: int, n_leaves: int):
    """``inner_loop`` / ``nc_inner_loop``: K steps, each the d message then
    the s message."""
    for k in jax.random.split(key, K):
        kd, ks = jax.random.split(k)
        yield from message_leaf_keys(kd, n_leaves)
        yield from message_leaf_keys(ks, n_leaves)


def round_leaf_keys(key, K: int, n_leaves: int):
    """One outer round (C2DFB or C2DFB-nc): the y loop, then the z loop."""
    ky, kz = jax.random.split(key)
    yield from inner_loop_leaf_keys(ky, K, n_leaves)
    yield from inner_loop_leaf_keys(kz, K, n_leaves)


def run_leaf_keys(key, T: int, K: int, n_leaves: int):
    """``c2dfb.run``: T rounds on ``split(key, T)``."""
    for kt in jax.random.split(key, T):
        yield from round_leaf_keys(kt, K, n_leaves)


def wire_leaf_keys(key, n_leaves: int):
    """``round_wire_bytes_measured``: per loop (y, z) one d and one s message."""
    for k in jax.random.split(key):
        kd, ks = jax.random.split(k)
        yield from message_leaf_keys(kd, n_leaves)
        yield from message_leaf_keys(ks, n_leaves)


def record_quant_margins(monkeypatch) -> list:
    """Record, for every quantization the port makes, the smallest distance
    |u - frac(steps)| between a sample and its rounding threshold: a code
    can flip between two runs only where that margin is below the runs'
    difference in steps.  Returns the list the margins are appended to."""
    import repro_torch.core.compression as pcomp
    import repro_torch.kernels.quantize as pquant

    margins = []
    plain = pquant.quantize_ref

    def recording(x2d, u2d, bits):
        levels = (1 << bits) - 1
        scale = torch.clamp_min(torch.amax(torch.abs(x2d), dim=-1, keepdim=True), 1e-12)
        steps = (x2d / scale + 1.0) * 0.5 * levels
        margins.append(float(torch.min(torch.abs(u2d - (steps - torch.floor(steps))))))
        return plain(x2d, u2d, bits)

    monkeypatch.setattr(pquant, "quantize_ref", recording)
    monkeypatch.setattr(pcomp, "quantize_ref", recording)
    return margins
