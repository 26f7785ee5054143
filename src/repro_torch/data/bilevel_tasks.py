"""The paper's two experimental tasks, with synthetic offline datasets
(``repro.data.bilevel_tasks``'s counterpart).

1. Coefficient tuning (paper §6.1, 20 Newsgroups analogue)
   UL:  f_i(x, y) = CE(val; linear classifier y)
   LL:  g_i(x, y) = CE(train; y) + y^T diag(exp(x)) y   (per-feature ridge)
   x = per-feature log regularization coefficients, y = (p, c) classifier.
   The real dataset has 101,631 tf-idf features and 20 classes.

2. Hyper-representation (paper §6.2, MNIST analogue)
   UL: backbone (two hidden layers), LL: classification head.
   f_i = CE(val), g_i = CE(train) + ridge on the head.

The numpy synthesis is the reference's, line for line, so the data arrays
equal ``repro``'s bit for bit.  The random initial points (``y0``, the
hyper-representation weights) come from a ``torch.Generator`` seeded with
``seed``; they cannot equal ``jax.random``'s draw, so parity tests carry the
reference's arrays across with ``repro_torch.core.convert.from_numpy``.

The losses are node-stacked: they take (m, ...) trees and return the (m,)
vector of per-node losses (see ``repro_torch.core.bilevel_problem``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.types import broadcast_nodes
from repro_torch.data.partition import label_skew_partition, stack_shards


def _softmax_xent(logits, labels, num_classes):
    """Per-node mean cross-entropy: logits (m, n, c), labels (m, n) -> (m,).
    The one-hot rows compare labels with a class range, as jax.nn.one_hot
    does: no host read of the labels, so the gradient traces."""
    logp = torch.log_softmax(logits, dim=-1)
    classes = torch.arange(num_classes, device=labels.device)
    onehot = (labels.unsqueeze(-1) == classes).to(logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1), dim=-1)


def _synth_classification(
    n: int, p: int, c: int, sparsity: float, seed: int, noise: float = 0.35
):
    """Sparse linear-separable-ish synthetic features (tf-idf analogue)."""
    rng = np.random.default_rng(seed)
    # class prototypes are sparse but strong (tf-idf-like: few active terms)
    centers = 3.0 * rng.normal(size=(c, p)) * (rng.random((c, p)) < max(sparsity, 4.0 / p))
    labels = rng.integers(0, c, size=n)
    feats = centers[labels] + noise * rng.normal(size=(n, p))
    feats *= rng.random((n, p)) < 0.6  # document-level term dropout
    # MinMax scale to [0, 1] as the paper does
    lo, hi = feats.min(axis=0), feats.max(axis=0)
    feats = (feats - lo) / np.maximum(hi - lo, 1e-9)
    return feats.astype(np.float32), labels.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TaskBundle:
    problem: BilevelProblem
    x0: object  # node-stacked UL init
    y0: object  # node-stacked LL init
    num_classes: int
    test_data: tuple  # (features, labels) for accuracy eval
    predict_fn: object = None

    def test_accuracy(self, x_bar, y_bar, predict_fn=None):
        feats, labels = self.test_data
        logits = (predict_fn or self.predict_fn)(x_bar, y_bar, feats)
        return float(torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32)))


def _shards(feats, labels, m, h, seed, device):
    n = feats.shape[0]
    n_tr = int(0.4 * n)
    n_val = int(0.3 * n)
    tr_f, tr_l = feats[:n_tr], labels[:n_tr]
    va_f, va_l = feats[n_tr : n_tr + n_val], labels[n_tr : n_tr + n_val]
    te_f, te_l = feats[n_tr + n_val :], labels[n_tr + n_val :]

    sh_tr = label_skew_partition(tr_l, m, h, seed)
    sh_va = label_skew_partition(va_l, m, h, seed + 1)

    def on_dev(a, labels_=False):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=torch.int64 if labels_ else torch.float32)

    data_g = {"a": on_dev(stack_shards(tr_f, sh_tr)), "b": on_dev(stack_shards(tr_l, sh_tr), True)}
    data_f = {"a": on_dev(stack_shards(va_f, sh_va)), "b": on_dev(stack_shards(va_l, sh_va), True)}
    return data_f, data_g, (on_dev(te_f), on_dev(te_l, True))


def coefficient_tuning_task(
    m: int = 10,
    n: int = 2000,
    p: int = 500,
    c: int = 10,
    h: float = 0.0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> TaskBundle:
    device = resolve_device(device)
    feats, labels = _synth_classification(n, p, c, sparsity=0.05, seed=seed)
    data_f, data_g, test_data = _shards(feats, labels, m, h, seed, device)

    def f(x, y, d):
        return _softmax_xent(torch.bmm(d["a"], y), d["b"], c)

    def g(x, y, d):
        ce = _softmax_xent(torch.bmm(d["a"], y), d["b"], c)
        reg = torch.sum(torch.exp(x).unsqueeze(-1) * y * y, dim=(1, 2))
        return ce + reg

    problem = BilevelProblem(f=f, g=g, data_f=data_f, data_g=data_g, m=m)
    gen = torch.Generator().manual_seed(seed)
    x0 = broadcast_nodes(torch.full((p,), -4.0, dtype=torch.float32, device=device), m)
    y0 = broadcast_nodes((0.01 * torch.randn((p, c), generator=gen)).to(device), m)

    def predict(x_bar, y_bar, a):
        return a @ y_bar

    return TaskBundle(
        problem=problem, x0=x0, y0=y0, num_classes=c, test_data=test_data,
        predict_fn=predict,
    )


def _synth_images(n: int, c: int, side: int, seed: int):
    """MNIST analogue: per-class Gaussian-blob prototypes + noise."""
    rng = np.random.default_rng(seed)
    d = side * side
    protos = rng.normal(size=(c, d)).astype(np.float32)
    labels = rng.integers(0, c, size=n)
    imgs = protos[labels] + 0.8 * rng.normal(size=(n, d)).astype(np.float32)
    imgs = (imgs - imgs.mean()) / (imgs.std() + 1e-8)  # paper's normalization
    return imgs.astype(np.float32), labels.astype(np.int32)


def hyper_representation_task(
    m: int = 10,
    n: int = 3000,
    side: int = 12,
    hidden: int = 32,
    c: int = 10,
    h: float = 0.0,
    ridge: float = 1e-3,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> TaskBundle:
    device = resolve_device(device)
    feats, labels = _synth_images(n, c, side, seed)
    d_in = side * side
    data_f, data_g, test_data = _shards(feats, labels, m, h, seed, device)

    def backbone(x, a):
        hdn = torch.tanh(torch.bmm(a, x["w1"]) + x["b1"].unsqueeze(1))
        hdn = torch.tanh(torch.bmm(hdn, x["w2"]) + x["b2"].unsqueeze(1))
        return hdn

    def logits_of(x, y, a):
        return torch.bmm(backbone(x, a), y["w"]) + y["b"].unsqueeze(1)

    def f(x, y, d):
        return _softmax_xent(logits_of(x, y, d["a"]), d["b"], c)

    def g(x, y, d):
        reg = ridge * (torch.sum(y["w"] ** 2, dim=(1, 2)) + torch.sum(y["b"] ** 2, dim=1))
        return _softmax_xent(logits_of(x, y, d["a"]), d["b"], c) + reg

    problem = BilevelProblem(f=f, g=g, data_f=data_f, data_g=data_g, m=m)
    gen = torch.Generator().manual_seed(seed)
    x0_single = {
        "w1": torch.randn((d_in, hidden), generator=gen) * (1.0 / np.sqrt(d_in)),
        "b1": torch.zeros((hidden,)),
        "w2": torch.randn((hidden, hidden), generator=gen) * (1.0 / np.sqrt(hidden)),
        "b2": torch.zeros((hidden,)),
    }
    y0_single = {
        "w": torch.randn((hidden, c), generator=gen) * (1.0 / np.sqrt(hidden)),
        "b": torch.zeros((c,)),
    }
    x0 = broadcast_nodes({k: v.to(device) for k, v in x0_single.items()}, m)
    y0 = broadcast_nodes({k: v.to(device) for k, v in y0_single.items()}, m)

    def predict(x_bar, y_bar, a):
        hdn = torch.tanh(a @ x_bar["w1"] + x_bar["b1"])
        hdn = torch.tanh(hdn @ x_bar["w2"] + x_bar["b2"])
        return hdn @ y_bar["w"] + y_bar["b"]

    return TaskBundle(
        problem=problem, x0=x0, y0=y0, num_classes=c, test_data=test_data,
        predict_fn=predict,
    )
