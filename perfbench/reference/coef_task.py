"""Plain coefficient tuning (arXiv:2410.14115 §6.1): the data, the two
losses and their gradients, in plain NumPy and PyTorch.

The data are the synthetic 20 Newsgroups stand-in that the paper's task
builder draws from its seed (a frozen copy of the draw, so the reference
derives every input again from the seed alone): sparse class prototypes,
noisy documents with term dropout, min-max scaled to [0, 1]; 40% of the
documents train (g), 30% validate (f); each split is dealt to the m nodes
with label skew h (a fraction h of each class to its home node c mod m,
the rest round robin), the shards cut to the smallest.

    f_i(x, y) = CE(A_val,i y; labels)                  (upper level)
    g_i(x, y) = CE(A_train,i y; labels) + sum exp(x) * y^2   (lower level)

x is each feature's log ridge coefficient (p,), y the (p, c) classifier.
The gradients are autograd's, in float32 with TF32 off (`Precision`).
The logits' long sum over the p features is taken in ``FEATURE_CHUNKS``
parts, each a product of its own, added in order: a float32 order other
than any one product's, so that the check reads what a sound reordering
of the program's long product (split-K, say) would read, and not the
identical bits of the same kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.c2dfb import Precision

FEATURE_CHUNKS = 8


def synth_classification(n: int, p: int, c: int, sparsity: float, seed: int, noise: float = 0.35):
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.normal(size=(c, p)) * (rng.random((c, p)) < max(sparsity, 4.0 / p))
    labels = rng.integers(0, c, size=n)
    feats = centers[labels] + noise * rng.normal(size=(n, p))
    feats *= rng.random((n, p)) < 0.6
    lo, hi = feats.min(axis=0), feats.max(axis=0)
    feats = (feats - lo) / np.maximum(hi - lo, 1e-9)
    return feats.astype(np.float32), labels.astype(np.int32)


def label_skew(labels: np.ndarray, m: int, h: float, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    buckets: list[list[int]] = [[] for _ in range(m)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        home = int(c) % m
        n_home = int(round(h * len(idx)))
        buckets[home].extend(idx[:n_home].tolist())
        for pos, j in enumerate(idx[n_home:]):
            buckets[(home + 1 + pos) % m].append(int(j))
    n_min = min(len(b) for b in buckets)
    out = []
    for b in buckets:
        arr = np.asarray(b)
        rng.shuffle(arr)
        out.append(arr[:n_min])
    return out


def shards(n: int, p: int, c: int, m: int, h: float, seed: int, device) -> tuple[dict, dict]:
    """(validation shards, training shards): features (m, n_i, p) float32 and
    labels (m, n_i) int64 on ``device``."""
    feats, labels = synth_classification(n, p, c, sparsity=0.05, seed=seed)
    n_tr, n_val = int(0.4 * n), int(0.3 * n)

    def split(lo, hi, s):
        f, lab = feats[lo:hi], labels[lo:hi]
        parts = label_skew(lab, m, h, s)
        return {"a": torch.from_numpy(np.stack([f[i] for i in parts])).to(device),
                "b": torch.from_numpy(np.stack([lab[i] for i in parts]).astype(np.int64)).to(device)}

    train = split(0, n_tr, seed)
    val = split(n_tr, n_tr + n_val, seed + 1)
    return val, train


def initial_point(p: int, c: int, m: int, seed: int, device) -> tuple[dict, dict]:
    """x0 = -4 for every coefficient, y0 = 0.01 N(0, 1) from a CPU
    ``torch.Generator`` seeded with the seed; the same on every node."""
    y = 0.01 * torch.randn((p, c), generator=torch.Generator().manual_seed(seed))
    x0 = {"": torch.full((m, p), -4.0, dtype=torch.float32, device=device)}
    y0 = {"": y.to(device).unsqueeze(0).repeat(m, 1, 1)}
    return x0, y0


class Oracles:
    """The four gradients C²DFB asks for, node-stacked, computed in float32
    and stored at the state's precision."""

    def __init__(self, val: dict, train: dict, c: int, precision: Precision):
        self.val, self.train, self.c, self.prec = val, train, c, precision

    def _ce(self, data: dict, y: torch.Tensor) -> torch.Tensor:
        a, y = self.prec.operand(data["a"]), self.prec.operand(y)
        cuts = np.linspace(0, a.shape[-1], FEATURE_CHUNKS + 1).round().astype(int)
        logits = torch.bmm(a[:, :, cuts[0]:cuts[1]], y[:, cuts[0]:cuts[1]])
        for lo, hi in zip(cuts[1:-1], cuts[2:]):
            logits = logits + torch.bmm(a[:, :, lo:hi], y[:, lo:hi])
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, data["b"].unsqueeze(-1)).squeeze(-1).mean(dim=1)

    def f(self, x, y):
        return self._ce(self.val, y)

    def g(self, x, y):
        return self._ce(self.train, y) + torch.sum(torch.exp(x).unsqueeze(-1) * y * y, dim=(1, 2))

    def _grad(self, loss, x, y, wrt: str) -> dict:
        with torch.enable_grad():
            xv = x[""].to(torch.float32).detach().requires_grad_(wrt == "x")
            yv = y[""].to(torch.float32).detach().requires_grad_(wrt == "y")
            wrt_v = xv if wrt == "x" else yv
            total = loss(xv, yv).sum()
            g = torch.autograd.grad(total, [wrt_v], allow_unused=True)[0] if total.requires_grad else None
        return {"": self.prec.store(torch.zeros_like(wrt_v) if g is None else g)}

    def begin_round(self, x):
        pass

    def grad_y_h(self, x, y, lam):
        return self._grad(lambda a, b: self.f(a, b) + lam * self.g(a, b), x, y, "y")

    def grad_y_g(self, x, z):
        return self._grad(self.g, x, z, "y")

    def grad_x_f(self, x, y):
        return self._grad(self.f, x, y, "x")

    def grad_x_g(self, x, y):
        return self._grad(self.g, x, y, "x")
