"""Event-driven asynchronous scheduler over a `repro_torch.net` fabric
(``repro.async_gossip.scheduler``'s counterpart: host numpy, verbatim).

Where `NetworkFabric.simulate_round` prices barrier-synchronized phases
(every node waits for every message, so one straggler stalls the world),
the ``AsyncScheduler`` executes a K-step gossip loop as a per-node event
timeline: each node keeps its own clock, transmits one packet per neighbor
per step (d- and s-residuals ride together), and its *mixing matrix is
gated on which neighbor reference points have actually arrived*.

Per node i, local step k:

    gate      policy-dependent wait (see below)
    mix       at t_mix = gate time, using the newest version commonly held
              with each neighbor (symmetric ages -> Eq. 7 preserved)
    compute   straggler-scaled local gradient work
    transmit  version-(k+1) packet to every neighbor; NIC egress
              serialization + the fabric's per-message arrival query
              (transfer + propagation + jitter) price the flight

Policies:

* ``sync``    — global barrier per step: every node's step k starts only
                when all version-k packets have landed everywhere.  Same
                math as the synchronous algorithm (all ages zero); this is
                the reference timing the async modes are compared against.
* ``bounded`` — node i may start step k once it holds version >= k - S from
                every neighbor (S = ``bound``).  Ages never exceed S.
* ``full``    — never wait: mix whatever has arrived (age capped only by
                the step index; version 0 is always held).

All dependencies point to strictly earlier versions, so a step-ordered
dynamic program yields the exact event-driven fixpoint.  Randomness
(stragglers, jitter) comes from the fabric's per-(seed, round) RNG on a
dedicated stream, so timelines are reproducible event-for-event and do not
perturb the fabric's own barrier pricing.

VERSION RULES.  Which version an edge mixes at step k is a protocol
choice, selected by ``version_rule``:

* ``common``        — the newest version held by BOTH endpoints at their
                      respective step-k mix times.  This is the freshest
                      symmetric choice, but it is a simulator idealization:
                      i's pick depends on j's receipts at j's (possibly
                      later wall-clock) mix time, which no deployment can
                      know without extra, here-unpriced coordination.
                      Kept as the default for continuity (bit-exact with
                      all pre-rule trajectories) and as the freshness
                      upper bound the realizable rules are compared to.
* ``deterministic`` — mix exactly version ``k - S`` (clipped to the
                      catch-up / frozen pre-dropout version under churn).
                      The bounded gate already guarantees both endpoints
                      causally hold that version before either mixes, and
                      the rule is a deterministic function of (k, S, lag)
                      known to both endpoints — so NO acks are needed, the
                      timeline reuses the existing gated wait times
                      unchanged, and every age is realizable as-is.
                      Requires a gated policy (``sync``/``bounded``); the
                      ``full`` policy has no such guarantee and rejects it.
* ``acked``         — keep common-version freshness, but pay for the
                      agreement: every data packet (catch-ups included) is
                      answered by a sequence-number ack that rides the
                      fabric with real egress serialization and arrival
                      pricing (``ACK_BYTES`` per ack, counted in
                      ``wire_bytes`` and reported as a separate ``ack``
                      stream).  Gated policies additionally wait until the
                      ack of their own version-(k - S) packet has returned,
                      so at mix time each endpoint provably KNOWS the other
                      holds the bound version — the coordination the common
                      rule assumed for free is now on the wire, perturbing
                      NIC contention and wait times measurably.

Acks are processed in the same deterministic (step, sender, neighbor)
order as data packets: an ack departs the receiver's NIC no earlier than
the data packet's arrival, and acks triggered by step-k packets serialize
on the receiver's NIC before its step-(k+1) data departures (a fixed
ack-priority discipline, so the step-ordered DP stays an exact fixpoint).
The outer x / s_x barriers are already global joins and carry no acks.

The round boundary DRAINS the wire: the outer barrier waits for every
in-flight residual, so the next round's version-0 reference points are
globally consistent ACROSS THE ACTIVE EDGES — which is why, on a static
graph, per-round age arrays satisfy ``age[k] <= k`` and histories can
restart each round.

TIME-VARYING EDGE SETS.  ``run_loop(active=...)`` restricts a loop to a
round's active subgraph (a `repro_torch.net.dynamic` schedule step).  Edges that
sit a round out carry no traffic, and the round-boundary drain cannot
refresh them — so the scheduler keeps a persistent per-edge ``version_lag``
(how many reference versions behind round-start the pair's common holding
is).  An edge absent for r rounds of a K-step loop re-enters with
``lag = r * K``: its first mixes see ``age = k + lag``, never age 0.
Because the inner protocol transmits CUMULATIVE residuals, a re-entering
edge must first exchange a dense catch-up of the current references
(version-0 packet, priced at ``catchup_bytes``) before any in-round
residual is applicable; the bounded gate waits for that catch-up (which is
how the bound stays enforced under churn), the full policy mixes the
frozen lag-old history until it lands.  ``advance_lag`` is the per-round
bookkeeping step the engine drives.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.async_gossip.mixing import deterministic_ages, required_depth
from repro_torch.net.fabric import NetworkFabric
from repro_torch.net.trace import StepEvent, TransferEvent
from repro_torch.transport.base import as_transport

POLICIES = ("sync", "bounded", "full")
VERSION_RULES = ("common", "deterministic", "acked")

#: bytes of one sequence-number ack packet under ``version_rule="acked"``
#: (a 32-bit sequence number + minimal framing; deliberately small so the
#: cost is dominated by egress serialization + propagation, not payload)
ACK_BYTES = 8


@dataclasses.dataclass(frozen=True)
class AsyncTimeline:
    """One K-step loop's simulated execution.

    ages        (K, m, m) int32 — per-step per-edge version age used by the
                mixing (symmetric; 0 on non-edges, inactive edges and the
                diagonal).  Under edge churn an edge re-entering with
                version lag L sees ``age = k + L`` until its catch-up
                packet lands.
    mix_s       (K, m) absolute sim time of each node's step-k mix
    finish_s    (K, m) absolute compute-finish times
    end_s       when the loop (incl. in-flight packets) has fully drained
    wire_bytes  total bytes put on all links (per-link accounting,
                including re-entry catch-up packets)
    node_wire_bytes  (m,) int64 — each SENDER's share of ``wire_bytes``
                (its egress over all directed edges and catch-ups); sums
                to ``wire_bytes`` exactly.  This is what the schema-v2
                per-node round records report for the simulator engines.
    ack_wire_bytes  ack-stream share of ``wire_bytes`` (0 except under
                ``version_rule="acked"``); ``wire_bytes`` is always the
                TOTAL including acks, so existing consumers price the
                agreement automatically.
    node_ack_wire_bytes  (m,) int64 — per-node ack egress (acks are the
                data RECEIVER's egress); sums to ``ack_wire_bytes``.
    """

    ages: np.ndarray
    mix_s: np.ndarray
    finish_s: np.ndarray
    end_s: float
    wire_bytes: int
    node_wire_bytes: np.ndarray | None = None
    ack_wire_bytes: int = 0
    node_ack_wire_bytes: np.ndarray | None = None

    @property
    def max_age(self) -> int:
        return int(self.ages.max()) if self.ages.size else 0

    def start_s(self, fallback: float) -> float:
        """The loop's true start: the earliest step-0 mix (loops overlap
        the previous loop's in-flight packets, so the prior end_s is NOT
        the start); ``fallback`` covers empty (K = 0) loops."""
        return float(self.mix_s[0].min()) if self.mix_s.size else float(fallback)


@dataclasses.dataclass(frozen=True)
class RoundTimeline:
    """One outer C2DFB round's precomputed scheduler execution — the unit
    of the timeline-replay API.  ``drive_round`` produces one per round
    (eagerly, interleaved with the round math) and ``replay_rounds``
    stacks T of them up front so the whole run can ride a single
    scan (the compiled runtime, `repro_torch.async_gossip.compiled`).

    x_end is the clock after the outer x barrier (the y-loop's start
    fallback for the ledger); t_end is the round boundary (after the s_x
    barrier).  ``outer_wire_bytes`` is the two barriers' dense traffic on
    the round's active directed edges — with the loops' own
    ``wire_bytes`` it gives the per-stream split the `repro_torch.obs` round
    record carries, produced HERE once so the eager engine and the
    compiled replay cannot account differently."""

    tl_y: AsyncTimeline
    tl_z: AsyncTimeline
    t_start: float
    x_end: float
    t_end: float
    outer_wire_bytes: int = 0
    outer_node_wire_bytes: np.ndarray | None = None

    @property
    def wire_bytes_by_stream(self) -> dict[str, int]:
        """Per-link bytes split by protocol stream (outer barriers, y
        loop, z loop, and — under ``version_rule="acked"`` only — the
        ``ack`` agreement stream) — the round's total is their sum.  The
        ``ack`` key is present only when its share is nonzero, so
        common/deterministic records stay byte-identical to pre-rule
        runs."""
        ack = int(self.tl_y.ack_wire_bytes) + int(self.tl_z.ack_wire_bytes)
        out = {
            "outer": int(self.outer_wire_bytes),
            "y": int(self.tl_y.wire_bytes) - int(self.tl_y.ack_wire_bytes),
            "z": int(self.tl_z.wire_bytes) - int(self.tl_z.ack_wire_bytes),
        }
        if ack:
            out["ack"] = ack
        return out

    @property
    def node_wire_bytes(self) -> np.ndarray | None:
        """(m,) per-sender egress over the whole round (outer barriers +
        both inner loops + catch-ups); sums to the round's total wire
        bytes.  None on timelines built before per-node accounting."""
        parts = (
            self.outer_node_wire_bytes,
            self.tl_y.node_wire_bytes,
            self.tl_z.node_wire_bytes,
        )
        if any(p is None for p in parts):
            return None
        return parts[0] + parts[1] + parts[2]

    def node_bytes_by_stream(self, i: int) -> dict[str, int] | None:
        """Node ``i``'s egress split by stream — the per-node companion
        to `wire_bytes_by_stream` (schema-v2 node rows carry this)."""
        if self.node_wire_bytes is None:
            return None

        def _ack(tl) -> int:
            a = tl.node_ack_wire_bytes
            return int(a[i]) if a is not None else 0

        ack = _ack(self.tl_y) + _ack(self.tl_z)
        out = {
            "outer": int(self.outer_node_wire_bytes[i]),
            "y": int(self.tl_y.node_wire_bytes[i]) - _ack(self.tl_y),
            "z": int(self.tl_z.node_wire_bytes[i]) - _ack(self.tl_z),
        }
        if ack:
            out["ack"] = ack
        return out


class AsyncScheduler:
    """Drives non-barrier gossip loops on a fabric, with per-node clocks
    persisting across loops and rounds (so a straggler's lag carries over
    until a barrier catches it up).

    ``fabric`` may be a `NetworkFabric` or any `repro_torch.transport.Transport`
    — the scheduler consumes arrival times (``egress_s`` /
    ``message_arrival`` / ``round_rng``) through the transport interface,
    so a backend that executes messages for real can feed the same gating
    logic.  A bare fabric is wrapped in a `SimTransport` (pure delegation,
    bit-exact with the pre-transport code path)."""

    def __init__(
        self,
        fabric: NetworkFabric,
        policy: str = "bounded",
        bound: int = 2,
        version_rule: str = "common",
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")
        if policy == "bounded" and bound < 0:
            raise ValueError("staleness bound must be >= 0")
        if version_rule not in VERSION_RULES:
            raise ValueError(
                f"unknown version_rule {version_rule!r}; have {VERSION_RULES}"
            )
        if version_rule == "deterministic" and policy == "full":
            raise ValueError(
                "version_rule='deterministic' needs a gated policy "
                "('sync' or 'bounded'): the full policy never waits, so "
                "nothing guarantees version k - S is held by both "
                "endpoints — use 'common' or 'acked' with policy='full'"
            )
        self.transport = as_transport(fabric)
        if self.transport is None:
            raise ValueError(
                "AsyncScheduler needs a NetworkFabric or a bound Transport"
            )
        self.transport._require_bound()  # unbound transports get the named
        self.fabric = self.transport.fabric  # "call bind(topo)" ValueError
        self.policy = policy
        self.bound = bound
        self.version_rule = version_rule
        m = self.fabric.topo.m
        self.clock = np.zeros(m)        # per-node absolute clocks
        self.egress_free = np.zeros(m)  # per-node NIC availability
        # per-edge reference-version lag (symmetric, versions behind
        # round-start); stays all-zero on a static graph, grows while a
        # schedule keeps an edge inactive, resets when the drain catches a
        # re-entered edge up
        self.version_lag = np.zeros((m, m), dtype=np.int64)
        self._mult_round: int | None = None
        self._mult: np.ndarray | None = None
        self._rng = None

    # ------------------------------------------------------------------
    def _round_state(self, round_idx: int):
        """Per-round straggler multipliers + jitter RNG (stream-separated
        from the fabric's own barrier draws)."""
        if self._mult_round != round_idx:
            self._rng = self.transport.round_rng(round_idx, stream=0xA5)
            self._mult = self.transport.straggler.sample(
                self._rng, self.fabric.topo.m
            )
            self._mult_round = round_idx
        return self._mult, self._rng

    def reset(self) -> None:
        self.clock[:] = 0.0
        self.egress_free[:] = 0.0
        self.version_lag[:] = 0
        self._mult_round = None

    # ------------------------------------------------------------------
    def _active_neighbors(self, active: np.ndarray | None):
        """Per-node neighbor lists restricted to ``active`` (same iteration
        order as the base topology so static-graph runs draw the fabric RNG
        identically with or without an all-true mask)."""
        neighbors = self.fabric.topo.neighbors
        if active is None:
            return neighbors
        return [
            [j for j in neigh if active[i, j]]
            for i, neigh in enumerate(neighbors)
        ]

    def advance_lag(self, active: np.ndarray | None, versions: int) -> None:
        """Per-round age bookkeeping across edge churn: the round-boundary
        drain catches ACTIVE edges up (lag -> 0); every inactive base edge
        falls ``versions`` further behind (the reference versions its
        endpoints produced but never exchanged).  An edge absent for r
        rounds therefore re-enters with lag r * versions — never age 0."""
        topo = self.fabric.topo
        for i in range(topo.m):
            for j in topo.neighbors[i]:
                if active is None or active[i, j]:
                    self.version_lag[i, j] = 0
                else:
                    self.version_lag[i, j] += versions

    @property
    def history_depth(self) -> int:
        """History slots the device side must carry for a K-step loop: the
        +1 covers age 0 (the current version)."""
        return 1 if self.policy == "sync" else self.bound + 1

    def depth_for(self, K: int, max_lag: int = 0) -> int:
        """Static history depth for a K-step loop under this scheduler's
        policy (`repro_torch.async_gossip.mixing.required_depth` — the shared
        sizing rule); ``max_lag`` covers re-entry version lag from edge
        churn."""
        return required_depth(self.policy, self.bound, K, max_lag)

    # ------------------------------------------------------------------
    def run_loop(
        self,
        K: int,
        node_bytes,
        round_idx: int,
        compute_s_step: float = 0.0,
        loop: str = "loop",
        trace: bool = True,
        active: np.ndarray | None = None,
        lag: np.ndarray | None = None,
        catchup_bytes: int = 0,
    ) -> AsyncTimeline:
        """Execute K gossip steps; ``node_bytes`` is the per-node packet
        size (int or length-m sequence) — each node sends that many bytes
        to each neighbor each step.

        ``active`` ((m, m) bool, symmetric) restricts the loop to a
        schedule round's edge set; ``lag`` ((m, m) int, symmetric —
        typically ``self.version_lag``) is each pair's reference-version
        lag at loop start.  Active edges with positive lag first exchange a
        dense version-0 catch-up packet of ``catchup_bytes`` (cumulative
        residuals are useless without it); until it lands the edge mixes
        its frozen history at ``age = k + lag``."""
        topo = self.fabric.topo
        m = topo.m
        neighbors = self._active_neighbors(active)
        mult, rng = self._round_state(round_idx)
        if np.isscalar(node_bytes):
            node_bytes = np.full(m, int(node_bytes))
        else:
            node_bytes = np.asarray(node_bytes, dtype=np.int64)
        if lag is None:
            lag = np.zeros((m, m), dtype=np.int64)
        else:
            lag = np.asarray(lag, dtype=np.int64)
        S = 0 if self.policy == "sync" else self.bound

        if catchup_bytes <= 0 and any(
            lag[i, j] > 0 for i in range(m) for j in neighbors[i]
        ):
            raise ValueError(
                "run_loop: an active edge has version lag > 0 but "
                "catchup_bytes is 0 — a re-entering edge must exchange a "
                "dense catch-up before residuals apply (otherwise the "
                "sync/bounded gates would wait forever); pass the dense "
                "per-node reference size as catchup_bytes"
            )

        # arrive[v, j, i]: absolute arrival at i of j's version-v packet.
        # Slot 0 is the round-start version: already held (-inf) on edges
        # with zero lag, else the re-entry catch-up packet's arrival.
        arrive = np.full((K + 1, m, m), np.inf)
        for i in range(m):
            for j in neighbors[i]:
                if lag[i, j] == 0:
                    arrive[0, i, j] = -np.inf
        mix_t = np.zeros((K, m))
        finish_t = np.zeros((K, m))
        ages = np.zeros((K, m, m), dtype=np.int32)
        total_bytes = 0
        node_wire = np.zeros(m, dtype=np.int64)  # per-sender egress
        tr = self.fabric.trace if trace else None

        acked = self.version_rule == "acked"
        # ack_arrive[v, src, dst]: absolute time the data SENDER src learns
        # dst holds src's version-v packet (the ack's return arrival)
        ack_arrive = np.full((K + 1, m, m), np.inf)
        ack_total = 0
        node_ack = np.zeros(m, dtype=np.int64)  # acks are RECEIVER egress

        def send_ack(v: int, src: int, dst: int, data_arrival: float,
                     phase: int) -> None:
            """dst answers src's version-v packet with a priced ack: real
            NIC egress serialization on dst plus the fabric's arrival
            model, in the fixed (step, sender, neighbor) processing order
            (ack-priority discipline — see the module docstring)."""
            nonlocal ack_total, total_bytes
            depart = max(self.egress_free[dst], data_arrival)
            self.egress_free[dst] = depart + self.transport.egress_s(ACK_BYTES)
            ack_arrive[v, src, dst] = self.transport.message_arrival(
                depart, ACK_BYTES, rng
            )
            ack_total += ACK_BYTES
            total_bytes += ACK_BYTES
            node_ack[dst] += ACK_BYTES
            node_wire[dst] += ACK_BYTES
            if tr is not None:
                tr.add_transfer(
                    TransferEvent(
                        round=round_idx, phase=phase, src=dst, dst=src,
                        bytes=ACK_BYTES, t_start=depart,
                        t_end=ack_arrive[v, src, dst],
                    )
                )

        # ---- re-entry catch-up: dense version-0 refs on lagged edges ------
        for i in range(m):
            for j in neighbors[i]:
                if lag[i, j] == 0 or catchup_bytes <= 0:
                    continue
                nbytes = int(catchup_bytes)
                depart = max(self.egress_free[i], self.clock[i])
                self.egress_free[i] = depart + self.transport.egress_s(nbytes)
                arrive[0, i, j] = self.transport.message_arrival(
                    depart, nbytes, rng
                )
                total_bytes += nbytes
                node_wire[i] += nbytes
                if tr is not None:
                    tr.add_transfer(
                        TransferEvent(
                            round=round_idx, phase=-2, src=i, dst=j,
                            bytes=nbytes, t_start=depart,
                            t_end=arrive[0, i, j],
                        )
                    )
                if acked:
                    send_ack(0, i, j, arrive[0, i, j], phase=-2)

        for k in range(K):
            # ---- gate + mix time ------------------------------------------
            if self.policy == "sync":
                # global barrier: all clocks and all version-k arrivals
                # (incl. outstanding catch-ups at k = 0)
                t = float(self.clock.max())
                for i in range(m):
                    for j in neighbors[i]:
                        if k >= 1:
                            t = max(t, arrive[k, j, i])
                            if acked:
                                t = max(t, ack_arrive[k, j, i])
                        elif lag[i, j] > 0:
                            t = max(t, arrive[0, j, i])
                            if acked:
                                t = max(t, ack_arrive[0, j, i])
                mix_t[k, :] = t
            else:
                for i in range(m):
                    t = self.clock[i]
                    if self.policy == "bounded":
                        need = k - S  # oldest version i may mix at step k
                        for j in neighbors[i]:
                            if lag[j, i] > 0 and need > -int(lag[j, i]):
                                # the frozen pre-dropout version is too old
                                # for the bound, and residuals are useless
                                # without their catch-up base — wait for it
                                # at EVERY such step (jitter can land it
                                # after later residual packets)
                                t = max(t, arrive[0, j, i])
                                if acked:
                                    # ...and for the returned ack of i's
                                    # OWN catch-up: only then does i know
                                    # j holds the shared base
                                    t = max(t, ack_arrive[0, i, j])
                            if need >= 1:
                                t = max(t, arrive[need, j, i])
                                if acked:
                                    # i must KNOW j holds i's version-need
                                    # packet before mixing a version the
                                    # bound admits — the agreement the
                                    # common rule assumed for free
                                    t = max(t, ack_arrive[need, i, j])
                    mix_t[k, i] = t

            # ---- compute + transmit ---------------------------------------
            for i in range(m):
                dur = compute_s_step * mult[i]
                finish_t[k, i] = mix_t[k, i] + dur
                self.clock[i] = finish_t[k, i]
                if tr is not None:
                    tr.add_step(
                        StepEvent(
                            round=round_idx, loop=loop, step=k, node=i,
                            t_start=mix_t[k, i], t_end=finish_t[k, i],
                        )
                    )
            for i in range(m):
                for j in neighbors[i]:
                    nbytes = int(node_bytes[i])
                    depart = max(self.egress_free[i], finish_t[k, i])
                    self.egress_free[i] = depart + self.transport.egress_s(nbytes)
                    arrive[k + 1, i, j] = self.transport.message_arrival(
                        depart, nbytes, rng
                    )
                    total_bytes += nbytes
                    node_wire[i] += nbytes
                    if tr is not None:
                        tr.add_transfer(
                            TransferEvent(
                                round=round_idx, phase=k, src=i, dst=j,
                                bytes=nbytes, t_start=depart,
                                t_end=arrive[k + 1, i, j],
                            )
                        )
                    if acked:
                        send_ack(k + 1, i, j, arrive[k + 1, i, j], phase=k)

        # ---- per-edge version ages (symmetric -> Eq. 7 preserved) ---------
        # deterministic rule: closed form — version k - S exactly, clipped
        # to the catch-up (0) / frozen pre-dropout (-lag) version under
        # churn; a pure function of (k, S, lag) both endpoints know, so the
        # age tensor is realizable with no coordination at all.
        if self.version_rule == "deterministic":
            ages = deterministic_ages(K, S, lag, neighbors)
        # common / acked rules: held[k, j, i] = newest version from j that
        # i holds at its step-k mix; the edge mixes on the newest COMMON
        # version min(held both ways, k), as with sequence-numbered acks
        # (which the acked rule actually sends and prices — its gate waits
        # on the returned acks, so the agreement is causally justified).
        # In-round residuals (v >= 1) only count once the catch-up /
        # round-start version is held (cumulative residuals need the full
        # prefix base); with nothing held the pair falls back to its frozen
        # pre-dropout common version, lag versions behind round start.
        else:
            for k in range(K):
                for i in range(m):
                    for j in neighbors[i]:
                        if j < i:
                            continue  # fill symmetric pairs once
                        held_i = held_j = None
                        if arrive[0, j, i] <= mix_t[k, i]:
                            held_i = 0
                            for v in range(min(k, K), 0, -1):
                                if arrive[v, j, i] <= mix_t[k, i]:
                                    held_i = v
                                    break
                        if arrive[0, i, j] <= mix_t[k, j]:
                            held_j = 0
                            for v in range(min(k, K), 0, -1):
                                if arrive[v, i, j] <= mix_t[k, j]:
                                    held_j = v
                                    break
                        if held_i is None or held_j is None:
                            common = -int(lag[i, j])
                        else:
                            common = min(held_i, held_j, k)
                        ages[k, i, j] = ages[k, j, i] = k - common

        # ---- drain: the loop is over when every packet has landed ---------
        # (acks included: the round boundary cannot cut an in-flight ack)
        end = float(self.clock.max()) if m else 0.0
        for i in range(m):
            for j in neighbors[i]:
                landed = arrive[:, i, j]
                landed = landed[np.isfinite(landed)]
                if landed.size:
                    end = max(end, float(landed.max()))
                if acked:
                    back = ack_arrive[:, i, j]
                    back = back[np.isfinite(back)]
                    if back.size:
                        end = max(end, float(back.max()))
        return AsyncTimeline(
            ages=ages, mix_s=mix_t, finish_s=finish_t, end_s=end,
            wire_bytes=total_bytes, node_wire_bytes=node_wire,
            ack_wire_bytes=ack_total, node_ack_wire_bytes=node_ack,
        )

    # ------------------------------------------------------------------
    def barrier_phase(
        self,
        node_bytes,
        round_idx: int,
        compute_s: float = 0.0,
        label: str = "outer",
        active: np.ndarray | None = None,
    ) -> float:
        """One barrier-synchronized dense exchange (the outer x / s_x
        broadcasts stay synchronous — Algorithm 1's round boundary).  All
        clocks join at the phase end; returns the phase end time.
        ``active`` restricts the exchange to a schedule round's edge set
        (dropped links carry no outer traffic either)."""
        topo = self.fabric.topo
        m = topo.m
        neighbors = self._active_neighbors(active)
        mult, rng = self._round_state(round_idx)
        if np.isscalar(node_bytes):
            node_bytes = np.full(m, int(node_bytes))
        tr = self.fabric.trace
        end = 0.0
        for i in range(m):
            ready = self.clock[i] + compute_s * mult[i]
            if tr is not None:
                tr.add_step(
                    StepEvent(
                        round=round_idx, loop=label, step=0, node=i,
                        t_start=self.clock[i], t_end=ready,
                    )
                )
            self.clock[i] = ready
            end = max(end, ready)
        for i in range(m):
            for j in neighbors[i]:
                nbytes = int(node_bytes[i])
                depart = max(self.egress_free[i], self.clock[i])
                self.egress_free[i] = depart + self.transport.egress_s(nbytes)
                t_arr = self.transport.message_arrival(depart, nbytes, rng)
                end = max(end, t_arr)
                if tr is not None:
                    tr.add_transfer(
                        TransferEvent(
                            round=round_idx, phase=-1, src=i, dst=j,
                            bytes=nbytes, t_start=depart, t_end=t_arr,
                        )
                    )
        self.clock[:] = end
        self.egress_free = np.maximum(self.egress_free, end)
        return end

    def drain(self, end_s: float) -> None:
        """Join all clocks at ``end_s`` (round boundary barrier)."""
        self.clock[:] = np.maximum(self.clock, end_s).max()
        self.egress_free = np.maximum(self.egress_free, self.clock.max())

    # ------------------------------------------------------------------
    # timeline replay API (one C2DFB round / T stacked rounds)
    # ------------------------------------------------------------------
    def drive_round(
        self,
        round_idx: int,
        K: int,
        bytes_y,
        bytes_z,
        outer_node_bytes,
        compute_s_step: float = 0.0,
        active: np.ndarray | None = None,
        catchup_bytes: int = 0,
        track_lag: bool = False,
    ) -> RoundTimeline:
        """Execute ONE outer C2DFB round's scheduler timeline: the x
        barrier, the two K-step inner loops (y, z), the round-boundary
        drain, the s_x barrier, and (with ``track_lag``) the per-round
        version-lag bookkeeping across edge churn.  This is the single
        code path both engines drive — the eager engine calls it once per
        round with codec-measured payload sizes, the compiled runtime
        replays it T times up front with analytic sizes."""
        lag = self.version_lag if track_lag else None
        t_start = float(self.clock.max())
        # the two dense barriers' per-link traffic on the active edge set
        # (each node sends its outer packet once per active neighbor per
        # barrier) — recorded on the RoundTimeline so every consumer reads
        # one accounting
        neigh = self._active_neighbors(active)
        m = self.fabric.topo.m
        if np.isscalar(outer_node_bytes):
            per_node = np.full(m, int(outer_node_bytes), dtype=np.int64)
        else:
            per_node = np.asarray(outer_node_bytes, dtype=np.int64)
        outer_node_wire = np.asarray(
            [2 * per_node[i] * len(v) for i, v in enumerate(neigh)],
            dtype=np.int64,
        )
        outer_wire = int(outer_node_wire.sum())
        self.barrier_phase(
            outer_node_bytes, round_idx, compute_s=compute_s_step,
            label="x", active=active,
        )
        x_end = float(self.clock.max())
        tl_y = self.run_loop(
            K, bytes_y, round_idx, compute_s_step, loop="y",
            active=active, lag=lag, catchup_bytes=catchup_bytes,
        )
        tl_z = self.run_loop(
            K, bytes_z, round_idx, compute_s_step, loop="z",
            active=active, lag=lag, catchup_bytes=catchup_bytes,
        )
        self.drain(max(tl_y.end_s, tl_z.end_s))
        t_end = self.barrier_phase(
            outer_node_bytes, round_idx, compute_s=compute_s_step,
            label="s_x", active=active,
        )
        if track_lag:
            self.advance_lag(active, K)
        return RoundTimeline(
            tl_y=tl_y, tl_z=tl_z, t_start=t_start, x_end=x_end, t_end=t_end,
            outer_wire_bytes=outer_wire,
            outer_node_wire_bytes=outer_node_wire,
        )

    def replay_rounds(
        self,
        T: int,
        K: int,
        bytes_y,
        bytes_z,
        outer_node_bytes,
        compute_s_step: float = 0.0,
        masks: np.ndarray | None = None,
        catchup_bytes: int = 0,
        track_lag: bool = False,
    ) -> list[RoundTimeline]:
        """Phase 1 of the compiled runtime: replay T rounds up front with
        ANALYTIC payload sizes (constant per run, so no round's timeline
        depends on the round math) and return the per-round timelines.
        Byte-for-byte the same scheduler calls — and therefore the same
        RNG draws, clocks, and ages — as T eager `drive_round` calls fed
        the same sizes."""
        return [
            self.drive_round(
                t, K, bytes_y, bytes_z, outer_node_bytes, compute_s_step,
                active=masks[t] if masks is not None else None,
                catchup_bytes=catchup_bytes, track_lag=track_lag,
            )
            for t in range(T)
        ]
