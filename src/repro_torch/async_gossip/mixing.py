"""Staleness-aware gossip mixing (``repro.async_gossip.mixing``'s
counterpart): the device half of the async engine.

Under asynchronous execution a node mixes whatever neighbor reference
points have actually ARRIVED, not the current ones.  Because reference
points evolve by cumulative residual updates, "the copy of j that i holds"
is simply j's reference at an earlier version; the engine therefore carries
a rolling HISTORY of the node-stacked reference tree (leading axis =
version age) and gates the mixing matrix with a per-edge integer age.

The delayed operator is the *pairwise-version* form

    mix_i = sum_j w_ij ( h[a_ij, j] - h[a_ij, i] )

where ``a_ij`` is the age of edge (i, j)'s newest COMMONLY-held version
(symmetric: a_ij == a_ji).  Node i subtracts its OWN value at that same
version — it keeps its full local history, so this costs no communication.
The symmetry preserves the paper's mean-dynamics invariant (Eq. 7) exactly:
for every unordered pair the two terms cancel in the node average, so

    d_bar^{k+1} = d_bar^k - eta * s_bar^k

holds under ANY symmetric delay pattern.  With all ages zero the operator
reduces to ``mix_delta_dense`` on the current references.

STALENESS-ADAPTIVE DAMPING.  ``damp_weights`` scales each edge's weight by
a decreasing function of its CURRENT age —

    none         w_ij
    inverse-age  w_ij / (1 + a_ij)
    exp-decay    w_ij * decay ** a_ij      (decay in (0, 1], default 0.5)

— and renormalizes by absorbing the removed mass into the diagonal
(W'_ii = 1 - sum_{j != i} W'_ij), so every realized matrix stays
symmetric, row-stochastic and non-negative.  Zero ages give a factor of
exactly 1.0, so the damped operator is bit-exact with the undamped one.

``required_depth`` and ``deterministic_ages`` are host numpy, verbatim.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Tree, tree_map

#: Staleness-adaptive damping policies for the delayed mixing operator.
DAMPING_POLICIES = ("none", "inverse-age", "exp-decay")


def validate_damping(policy: str) -> str:
    """Reject unknown damping policies up front (before a run starts),
    with the one canonical error message; returns the policy."""
    if policy not in DAMPING_POLICIES:
        raise ValueError(f"unknown mixing_damping {policy!r}; have {DAMPING_POLICIES}")
    return policy


def damping_factor(ages, policy: str, decay: float = 0.5) -> torch.Tensor:
    """Per-edge weight multiplier phi(a) in (0, 1], with phi(0) == 1.0
    exactly (x * 1.0 == x, so zero-age edges are undamped bit for bit).
    ``ages`` is any integer array or tensor; the f32 factor has its shape
    (and its device, for a tensor)."""
    validate_damping(policy)
    a = torch.as_tensor(ages).to(torch.float32)
    if policy == "none":
        return torch.ones_like(a)
    if policy == "inverse-age":
        return 1.0 / (1.0 + a)
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"exp-decay needs decay in (0, 1], got {decay}")
    # the base is filled on the device (no host copy), so a captured round
    # can hold it
    return torch.pow(torch.full_like(a, decay), a)


def damp_weights(W: torch.Tensor, ages, policy: str, decay: float = 0.5) -> torch.Tensor:
    """The realized age-damped mixing matrix: off-diagonal
    ``W'_ij = W_ij * phi(a_ij)``, diagonal renormalized to
    ``1 - sum_{j != i} W'_ij``.  With ``policy="none"`` returns ``W``
    unchanged (bit-exact fast path)."""
    if policy == "none":
        return W
    m = W.shape[0]
    eye = torch.eye(m, dtype=W.dtype, device=W.device)
    phi = damping_factor(torch.as_tensor(ages, device=W.device), policy, decay).to(W.dtype)
    off = W * (1.0 - eye) * phi
    return off + torch.diag(1.0 - off.sum(dim=1))


def required_depth(policy: str, bound: int, K: int, max_lag: int = 0) -> int:
    """STATIC history depth a K-step delayed loop must carry under a gating
    policy — the one sizing rule every consumer (the scheduler's
    ``depth_for``, the eager engine) shares.

    With ``max_lag`` > 0 (edges re-entering from a topology schedule, or
    lag carried in by an injected scheduler) every realizable age is
    bounded by (K - 1) + max_lag for the never-waiting full policy, and by
    the bound for bounded (whose gate also admits lag-old versions while
    lag <= bound - k); the +1 everywhere covers age 0 (the current
    version).  Sync ages are provably zero, so one slot always suffices.
    """
    if policy == "sync" or max_lag <= 0:
        if policy == "full":
            return max(1, K)
        if policy == "bounded":
            return min(bound + 1, max(1, K))
        return 1
    max_possible_age = K - 1 + max_lag
    if policy == "full":
        return max_possible_age + 1
    return min(bound, max_possible_age) + 1


def deterministic_ages(K: int, S: int, lag: np.ndarray, neighbors) -> np.ndarray:
    """Closed-form (K, m, m) age tensor for the scheduler's
    ``version_rule="deterministic"``: at step k every active edge mixes
    exactly version ``k - S`` (S = the staleness bound, 0 for sync),
    clipped under churn to the catch-up version 0 while ``k - S`` is not
    yet a positive in-round version, and to the frozen pre-dropout version
    ``-lag`` while the bound still admits it (``k - S <= -lag``).

    Both endpoints can compute it locally with no coordination, it is
    symmetric by construction (lag is), and every age is <= max(S, 0).
    ``neighbors`` is the loop's ACTIVE per-node neighbor lists; non-edges
    stay age 0.
    """
    m = len(neighbors)
    lag = np.asarray(lag, dtype=np.int64)
    ages = np.zeros((K, m, m), dtype=np.int32)
    for k in range(K):
        for i in range(m):
            for j in neighbors[i]:
                if j < i:
                    continue  # fill symmetric pairs once
                v = k - S
                if v < 1:
                    v = 0 if v > -int(lag[i, j]) else -int(lag[i, j])
                ages[k, i, j] = ages[k, j, i] = k - v
    return ages


def init_history(tree: Tree, depth: int) -> Tree:
    """(depth, m, ...) history with every slot holding the current version.

    Slot 0 is the newest version; at local step k slot ``a`` holds version
    ``k - a`` (clamped at the round's initial version, which is what every
    slot starts as — correct because age <= step by construction)."""
    return tree_map(lambda v: v.unsqueeze(0).expand((depth,) + tuple(v.shape)).clone(), tree)


def push_history(hist: Tree, new: Tree) -> Tree:
    """Shift the history one version: slot 0 becomes ``new`` (a new
    tensor; the old history is not updated in place)."""
    return tree_map(lambda h, n: torch.cat([n.unsqueeze(0), h[:-1]], dim=0), hist, new)


def mix_delta_delayed(
    W: torch.Tensor, hist: Tree, ages: torch.Tensor, damping: str = "none", decay: float = 0.5
) -> Tree:
    """sum_j w'_ij (h[a_ij, j] - h[a_ij, i]) for a history tree.

    ``ages`` is an (m, m) integer tensor of per-edge version ages on the
    history's device, symmetric and < history depth; entries on non-edges
    (w_ij = 0) and the diagonal are ignored by the weighting.  ``damping``
    selects the staleness-adaptive weight policy.  The gathered views
    ``theirs`` and ``mine`` are (m, m, d); one batched product of the
    (m, m) weights with their difference sums over j, in f32, emitted at
    the leaf dtype (the reference's einsum, with its operands)."""
    m = ages.shape[0]
    rows = torch.arange(m, device=ages.device)[:, None]
    cols = torch.arange(m, device=ages.device)[None, :]
    Wf = W.to(torch.float32)
    if damping != "none":
        Wf = Wf * damping_factor(ages, damping, decay)
    idx = ages.to(torch.int64)

    def leaf(h):
        flat = h.reshape(h.shape[0], m, -1).to(torch.float32)
        theirs = flat[idx, cols]  # (m, m, d): h[a_ij, j]
        mine = flat[idx, rows]     # (m, m, d): h[a_ij, i]
        out = torch.bmm(Wf.unsqueeze(1), theirs - mine).squeeze(1)
        return out.reshape(h.shape[1:]).to(h.dtype)

    return tree_map(leaf, hist)


class DelayedMixer:
    """`repro_torch.core.inner_loop.inner_loop`'s mixer under staleness:
    step k mixes the d and s reference HISTORIES gated by ``ages[k]``
    (`mix_delta_delayed`).  Each call first pushes the references the
    previous step produced, so slot 0 always holds the current version;
    `histories` pushes the loop's last references and returns the
    ``(hist_d, hist_s)`` pair that a cross-round carry needs."""

    def __init__(self, W, hist_d: Tree, hist_s: Tree, ages: torch.Tensor, damping: str = "none",
                 decay: float = 0.5):
        self.W, self.ages, self.damping, self.decay = W, ages, damping, decay
        self.hist_d, self.hist_s = hist_d, hist_s
        self._step = 0
        self._pending = False  # a step ran whose references are not pushed yet

    def _push(self, state) -> None:
        if self._pending:
            self.hist_d = push_history(self.hist_d, state.d_hat)
            self.hist_s = push_history(self.hist_s, state.s_hat)
            self._pending = False

    def __call__(self, state) -> tuple[Tree, Tree]:
        self._push(state)
        ages = self.ages[self._step]
        self._step += 1
        self._pending = True
        return (
            mix_delta_delayed(self.W, self.hist_d, ages, self.damping, self.decay),
            mix_delta_delayed(self.W, self.hist_s, ages, self.damping, self.decay),
        )

    def histories(self, state) -> tuple[Tree, Tree]:
        self._push(state)
        return self.hist_d, self.hist_s
