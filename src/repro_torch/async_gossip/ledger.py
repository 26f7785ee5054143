"""Staleness ledger — per-edge reference-point age as a first-class metric
(``repro.async_gossip.ledger``'s counterpart: host numpy, verbatim).

Convergence claims for asynchronous gossip are only meaningful against the
staleness the run actually experienced, so the ledger records every loop's
(K, m, m) age tensor next to the simulated clock, and turns them into the
round metrics the benchmarks plot:

* per-round age histograms (``hist``), max and mean age;
* the consensus-error-vs-simulated-seconds curve (``curve``) that
  time-to-accuracy comparisons (sync vs bounded-stale vs fully-async) are
  read off of.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def edge_age_samples(ages_list, edges) -> np.ndarray:
    """Flatten loop age tensors to the DIRECTED-edge samples the
    staleness metrics are computed over: only ``edges`` positions count
    (idle diagonal / non-edge zeros would dilute every statistic).
    ``ages_list`` is any iterable of (K, m, m) tensors (the round's y and
    z loops, or T stacked rounds one at a time)."""
    if not edges:
        return np.zeros(0, np.int32)
    idx = tuple(zip(*edges))
    return np.concatenate(
        [np.asarray(a)[..., idx[0], idx[1]].reshape(-1) for a in ages_list]
    )


def staleness_stats(
    samples: np.ndarray, depth: int
) -> tuple[np.int32, np.float64, np.ndarray]:
    """One round's (staleness_max, staleness_mean, staleness_hist) from
    its flat edge-age samples — the single definition both the eager
    engine's per-round rows and the compiled runtime's post-hoc pass use,
    so the two metric streams agree entry-for-entry."""
    return (
        np.int32(samples.max(initial=0)),
        np.float64(samples.mean() if samples.size else 0.0),
        np.bincount(samples, minlength=depth)[:depth].astype(np.int64),
    )


def node_staleness_stats(
    ages_list, edges, m: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-NODE (max, mean) age over each node's incident directed-edge
    samples — what the schema-v2 node records report.  A node's samples
    are the ages of the in-edges ``(j, i)`` it mixes on (symmetric age
    tensors make the in/out choice immaterial on undirected graphs, but
    the in-edge reading is what bounds node i's own mixing error).
    Returns ``(max (m,) int32, mean (m,) float64)``; isolated nodes
    report (0, 0.0)."""
    nmax = np.zeros(m, np.int32)
    nmean = np.zeros(m, np.float64)
    for i in range(m):
        incident = [e for e in edges if e[1] == i]
        samples = edge_age_samples(ages_list, incident)
        if samples.size:
            nmax[i] = samples.max()
            nmean[i] = samples.mean()
    return nmax, nmean


def replay_staleness_rows(
    rounds, edges_per_round, depth: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-round staleness metric ARRAYS from a precomputed timeline
    replay (`AsyncScheduler.replay_rounds` output): the compiled
    runtime's vectorized twin of the eager engine's per-round
    bookkeeping.  Returns ``(staleness_max (T,), staleness_mean (T,),
    staleness_hist (T, depth))``."""
    smax = np.zeros(len(rounds), np.int32)
    smean = np.zeros(len(rounds), np.float64)
    shist = np.zeros((len(rounds), depth), np.int64)
    for t, rt in enumerate(rounds):
        samples = edge_age_samples(
            (rt.tl_y.ages, rt.tl_z.ages), edges_per_round[t]
        )
        smax[t], smean[t], shist[t] = staleness_stats(samples, depth)
    return smax, smean, shist


@dataclasses.dataclass(frozen=True)
class LoopRecord:
    round: int
    loop: str              # "y" | "z"
    ages: np.ndarray       # (K, m, m) int32, symmetric
    t_start: float
    t_end: float
    #: directed edges that were ACTIVE for this loop (None = the full
    #: graph); under a topology schedule only these positions of ``ages``
    #: are meaningful — inactive edges carry no traffic and record 0
    edges: tuple | None = None


class StalenessLedger:
    """Append-only record of per-edge ages and convergence checkpoints."""

    def __init__(self) -> None:
        self.loops: list[LoopRecord] = []
        self._curve_t: list[float] = []
        self._curve_err: list[float] = []

    # -- recording ----------------------------------------------------------
    def record_loop(
        self, round_idx: int, loop: str, ages: np.ndarray,
        t_start: float, t_end: float, edges: tuple | None = None,
    ) -> None:
        self.loops.append(
            LoopRecord(
                round=round_idx, loop=loop,
                ages=np.asarray(ages, dtype=np.int32),
                t_start=float(t_start), t_end=float(t_end),
                edges=tuple(edges) if edges is not None else None,
            )
        )

    def record_point(self, sim_s: float, consensus_err: float) -> None:
        """One (simulated seconds, consensus error) convergence checkpoint —
        called by the engine at each round boundary."""
        self._curve_t.append(float(sim_s))
        self._curve_err.append(float(consensus_err))

    def record_replay(
        self, rounds, x_errs, edges_per_round
    ) -> None:
        """Post-hoc BULK recording for the compiled runtime: one pass over
        a precomputed timeline replay (`AsyncScheduler.replay_rounds`)
        appends exactly the LoopRecords and convergence checkpoints the
        eager engine would have recorded round-by-round — same loop tags,
        same start fallbacks (a loop's true start is its earliest step-0
        mix), same active-edge masking."""
        for t, rt in enumerate(rounds):
            edges = edges_per_round[t]
            self.record_loop(t, "y", rt.tl_y.ages,
                             rt.tl_y.start_s(rt.x_end), rt.tl_y.end_s,
                             edges=edges)
            self.record_loop(t, "z", rt.tl_z.ages,
                             rt.tl_z.start_s(rt.tl_y.end_s), rt.tl_z.end_s,
                             edges=edges)
            self.record_point(rt.t_end, float(x_errs[t]))

    # -- queries ------------------------------------------------------------
    def round_ages(self, round_idx: int) -> np.ndarray:
        """All edge ages observed in one round, flattened (active edges
        only — zero-weight pairs never enter the ledger's loop records with
        nonzero age, but we keep the raw tensors and mask upstream)."""
        recs = [r.ages for r in self.loops if r.round == round_idx]
        return (
            np.concatenate([a.reshape(-1) for a in recs])
            if recs else np.zeros(0, np.int32)
        )

    def max_age(self) -> int:
        return max((int(r.ages.max()) for r in self.loops), default=0)

    @staticmethod
    def _record_ages(r: LoopRecord, edges) -> np.ndarray:
        """A record's age samples: explicit ``edges`` wins, else the
        record's own active-edge set (schedule runs), else every entry."""
        use = edges if edges is not None else r.edges
        if use is None:
            return r.ages.reshape(-1)
        if not use:
            return np.zeros(0, np.int32)
        idx = tuple(zip(*use))
        return r.ages[:, idx[0], idx[1]].reshape(-1)

    def mean_age(self, edges=None) -> float:
        """Mean age over recorded steps; restrict to ``edges`` (directed
        pairs) when given so idle (i, i) / non-edge zeros don't dilute it.
        Records carrying their own active-edge set (schedule-composed
        runs) are masked to it automatically."""
        if not self.loops:
            return 0.0
        vals = np.concatenate(
            [self._record_ages(r, edges) for r in self.loops]
        )
        return float(vals.mean()) if vals.size else 0.0

    def histogram(self, max_age: int | None = None, edges=None) -> np.ndarray:
        """Counts of observed ages 0..max_age over all recorded steps
        (masked to each record's active edges like ``mean_age``)."""
        if max_age is None:
            max_age = self.max_age()
        counts = np.zeros(max_age + 1, dtype=np.int64)
        for r in self.loops:
            a = self._record_ages(r, edges)
            c = np.bincount(a, minlength=max_age + 1)
            counts += c[: max_age + 1]
        return counts

    def curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(sim_seconds, consensus_err) checkpoints in round order."""
        return np.asarray(self._curve_t), np.asarray(self._curve_err)

    def time_to_error(self, target_err: float) -> float:
        """First simulated time at which the consensus error checkpoint
        dropped to ``target_err`` (inf if never)."""
        t, e = self.curve()
        hit = np.nonzero(e <= target_err)[0]
        return float(t[hit[0]]) if hit.size else float("inf")
