"""Decentralized communication topologies and gossip mixing matrices
(``repro.core.topology``'s counterpart, numpy only).

Produces doubly-stochastic, symmetric mixing matrices W (paper Assumption 1)
via Metropolis–Hastings weights over an undirected connected graph, plus the
spectral quantities the theory uses:

* spectral gap  rho = 1 - max(|lambda_2|, |lambda_m|)        (Definition 3)
* rho' = ||W - I||_2^2 = sigma_max(W - I)^2                  (Lemma 4)

Graphs are plain adjacency sets with networkx's conventions (a self-loop
adds 2 to a node's degree), so every W here equals the reference's W
exactly without importing networkx.  ``erdos_renyi`` depends on networkx's
random generator and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    m: int
    W: np.ndarray           # (m, m) doubly stochastic, symmetric
    neighbors: tuple        # tuple of tuples: neighbors[i] excludes i
    # Static ring-like topologies have a shift schedule:
    # list of (shift, weight) meaning "receive from rank (r - shift) % m".
    ppermute_schedule: tuple | None = None

    @property
    def spectral_gap(self) -> float:
        lams = np.sort(np.linalg.eigvalsh(self.W))
        second = max(abs(lams[-2]), abs(lams[0]))
        return float(1.0 - second)

    @property
    def rho_prime(self) -> float:
        s = np.linalg.svd(self.W - np.eye(self.m), compute_uv=False)
        return float(s[0] ** 2)

    def validate(self):
        W = self.W
        if not np.allclose(W, W.T):
            raise ValueError("W must be symmetric")
        if not np.allclose(W.sum(axis=0), 1.0):
            raise ValueError("W must be doubly stochastic")
        if not np.all(W >= -1e-12):
            raise ValueError("W must be non-negative")
        if not _connected(W > 1e-12):
            raise ValueError("graph must be connected")
        return True


def _connected(adj: np.ndarray) -> bool:
    """Breadth-first search over the off-diagonal entries of ``adj``."""
    m = adj.shape[0]
    seen = {0}
    todo = deque([0])
    while todo:
        i = todo.popleft()
        for j in np.flatnonzero(adj[i]):
            j = int(j)
            if j != i and j not in seen:
                seen.add(j)
                todo.append(j)
    return len(seen) == m


def _adjacency(m: int, edges: Iterable[tuple[int, int]]) -> list[set]:
    adj = [set() for _ in range(m)]
    for i, j in edges:
        adj[i].add(j)
        adj[j].add(i)
    return adj


def metropolis_weights(edges: Iterable[tuple[int, int]], m: int) -> np.ndarray:
    """Metropolis–Hastings mixing matrix for an undirected graph on m nodes
    given as an edge list: symmetric, doubly stochastic, non-negative for
    any (even disconnected) graph."""
    adj = _adjacency(m, edges)
    deg = [len(a) + (i in a) for i, a in enumerate(adj)]  # self-loop counts 2
    W = np.zeros((m, m))
    for i in range(m):
        for j in adj[i]:
            if i == j:
                continue
            w = 1.0 / (1 + max(deg[i], deg[j]))
            W[i, j] = w
            W[j, i] = w
    for i in range(m):
        W[i, i] = 1.0 - W[i].sum()
    return W


def _from_edges(name: str, edges, m: int, schedule=None) -> Topology:
    edges = list(edges)
    W = metropolis_weights(edges, m)
    adj = _adjacency(m, edges)
    neigh = tuple(tuple(sorted(adj[i])) for i in range(m))
    topo = Topology(name=name, m=m, W=W, neighbors=neigh, ppermute_schedule=schedule)
    topo.validate()
    return topo


def _cycle(m: int) -> list[tuple[int, int]]:
    return [(i, (i + 1) % m) for i in range(m)]


def ring(m: int) -> Topology:
    """Each node linked to its two immediate neighbors (paper §6.1)."""
    # Metropolis on a cycle: every edge weight 1/3, self 1/3 (for m > 2).
    w = 1.0 / 3.0
    schedule = ((1, w), (-1, w)) if m > 2 else ((1, 0.5),)
    return _from_edges("ring", _cycle(m), m, schedule)


def two_hop(m: int) -> Topology:
    """Ring plus neighbors-of-neighbors (paper's 2-hop topology)."""
    edges = _cycle(m) + [(i, (i + 2) % m) for i in range(m)]
    w = 1.0 / 5.0
    schedule = ((1, w), (-1, w), (2, w), (-2, w)) if m > 4 else None
    return _from_edges("two_hop", edges, m, schedule)


def erdos_renyi(m: int, p: float = 0.4, seed: int = 0) -> Topology:
    raise ValueError(
        "topology 'er' (erdos_renyi) is not ported yet: it reproduces "
        "networkx's random graph generator, which a later slice ports"
    )


def complete(m: int) -> Topology:
    return _from_edges("complete", [(i, j) for i in range(m) for j in range(i + 1, m)], m)


def star(m: int) -> Topology:
    return _from_edges("star", [(0, j) for j in range(1, m)], m)


def torus2d(rows: int, cols: int) -> Topology:
    """Twisted 2D torus: circulant graph C_m(1, cols).

    The +/-1 ring wraps across row boundaries (i -> (i+1) mod m); +/-cols
    edges are the second mesh dimension, so the graph is exactly four
    global shifts.
    """
    m = rows * cols
    edges = [e for i in range(m) for e in ((i, (i + 1) % m), (i, (i + cols) % m))]
    w = 1.0 / 5.0
    schedule = ((1, w), (-1, w), (cols, w), (-cols, w))
    return _from_edges("torus2d", edges, m, schedule)


_FACTORIES = {
    "ring": ring,
    "two_hop": two_hop,
    "er": erdos_renyi,
    "complete": complete,
    "star": star,
}


def make_topology(name: str, m: int, **kwargs) -> Topology:
    if name == "torus2d":
        rows = kwargs.get("rows", int(np.sqrt(m)))
        return torus2d(rows, m // rows)
    if name not in _FACTORIES:
        raise ValueError(f"unknown topology {name!r}; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](m, **kwargs)
