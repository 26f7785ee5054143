"""`DeviceTransport` (``repro.transport.device``'s counterpart): the gossip
protocol EXECUTED between the ranks of a node mesh.

Where `SimTransport` prices phases on a simulated wire, this backend runs
them.  The reference is in-process: one JAX process and a `Mesh` of
devices, one node per device, every exchange a ``shard_map`` collective.
The port is in-process too, with all m ranks on the run's device: rank r
is row r of every node-stacked tensor, and an exchange moves exactly what
the reference's collective moves.

* **Neighbour shifts** (ring, two-hop, torus: topologies with a
  ``ppermute_schedule``): "rank r receives from rank r - shift" is
  `repro_torch.core.gossip.shift_ranks` (``torch.roll``), a device copy of
  the payload's bytes.  Each rank keeps one copy of its neighbour's
  reference point per shift, refreshed only by received residuals, and
  mixes ``acc = acc + w * (copy - own)`` shift by shift in f32.
* **All-gather** (general graphs): every rank receives every slice; the
  gathered table is the same for every rank, so one stacked table serves
  them all, and rank r mixes with its row of W - I against it.

The tensors crossing rank boundaries are the protocol's ACTUAL wire
payloads: the compressed residuals of Algorithm 2's reference-point
exchanges and the dense x / s_x outer broadcasts.  With ``fused=True``
(block-sparse compressors) every residual is packed on the device into
``(vals, idx)`` records (B2, one launch over every rank's blocks of a
leaf), the shifts / gather move the records, and every receiver, and the
sender for its own reference, unpacks them straight into the leaf, added to
the copy or reference it updates (B3's leaf entry, one launch over every
rank's records).  Every shift and gather reports what one rank receives to
the round-cost counters (`repro_torch.core.gossip.shift_tree` /
`gather_tree`), so a metered round's ``collective_bytes`` is the
reference's per-device count of its collectives.

Wire truth: after each round every executed payload makes the
`repro_torch.net.wire` encode -> decode round trip per node on the host
(`meter_round`), so byte counts are integers produced by running codec
code on the real messages, and the codec's delivery is verified message
for message (bit-exact; `KernelQuant` to rtol 1e-5, the reference's
allowance for its 1-ulp dequantization) unless ``verify=False``.  Only this metering runs on the
host; the exchange itself never leaves the device.

Parity: a run through `make_device_round` reproduces the node-stacked
simulator within f32 tolerance.  The compressors are the simulator's own
stacked calls (`inner_loop.inner_transmit`), so a stochastic compressor
draws exactly what the simulator draws; the only difference is the order
of the mixing sums.  Copies are rebuilt from the current references at
round start (a setup exchange, not charged to ``wire_bytes``: a round's wire
accounting counts the protocol's 2 dense outer + 4K compressed inner
messages; ``collective_bytes`` counts it, as the reference's HLO does).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import compression as C
from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.compression import Compressor
from repro_torch.core.gossip import gather_tree, mix_delta_shard, mix_gathered, mix_received, shift_tree, w_minus_i
from repro_torch.core.inner_loop import InnerState, inner_transmit, refresh_tracker
from repro_torch.core.topology import Topology
from repro_torch.core.types import Tree, tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.pack_residuals import pack_sparse_blocks, padded_k, unpack_sparse_blocks_into
from repro_torch.net import wire
from repro_torch.net.fabric import NetworkFabric, StragglerModel
from repro_torch.net.wire import codec_for
from repro_torch.transport.base import ExchangeReport, Transport


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """m ranks, all on ``device``: rank r is row r of every node-stacked
    tensor (the reference's 1-D `Mesh` of m devices, one node each)."""

    m: int
    device: torch.device


def mesh_for_nodes(m: int, device: str | torch.device | None = None) -> NodeMesh:
    """A mesh of ``m`` ranks on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``)."""
    if m < 1:
        raise ValueError(f"a mesh needs at least one rank, got {m}")
    return NodeMesh(m=int(m), device=resolve_device(device))


def _on(tree, device):
    """Every tensor of ``tree`` (through dicts, lists and named tuples) on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_on(v, device) for v in tree))
    return tree


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (f32 for a float leaf, as the codecs
    read it; int32 records stay int32)."""
    t = t.detach()
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.cpu().numpy()


def _per_node(fn, m: int) -> list:
    """``[fn(i) for i in range(m)]``: the m nodes' host codec work on a pool
    of threads (numpy and torch release the interpreter lock for the bulk
    of it).  A node's exception is raised here."""
    with ThreadPoolExecutor(max_workers=min(m, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, range(m)))


def _stack(trees: list) -> Tree:
    """A list of trees (or of (vals, idx) tree pairs) as one tree whose
    leaves stack the list on a new leading axis."""
    if isinstance(trees[0], tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(trees[0])))
    return tree_map(lambda *vs: torch.stack(vs), trees[0], *trees[1:])


# ---------------------------------------------------------------------------
# fused on-device compression: packed (vals, idx) record form on the wire
# ---------------------------------------------------------------------------


def fused_pack_spec(compressor: Compressor) -> tuple[int, int]:
    """(block, kpad) of the fused packed exchange, or raise for compressors
    whose residuals are not block-sparse tiles.  ``kpad`` is the per-block
    record budget (k rounded up to 128 lanes), so the packed form moves
    ``nb * kpad * 8`` bytes per leaf where the dense tile form moves
    ``nb * block * 4``."""
    if not isinstance(compressor, (C.BlockTopK, C.KernelBlockTopK)):
        raise ValueError(
            "fused on-device compression needs a block-sparse compressor "
            "(block_topk / kernel_topk) whose survivors fit the packed "
            f"(vals, idx) record form; got {type(compressor).__name__}"
        )
    block = compressor.block
    k = max(1, int(round(compressor.ratio * block)))
    return block, padded_k(k)


def _pack_tree(tree: Tree, block: int, kpad: int) -> tuple[Tree, Tree]:
    """Every rank's residual tree (leaves (m, *shape)) -> packed record trees
    ``(vals, idx)`` with leaves (m, nb, kpad): each leaf's blocks of every
    rank in ONE pack launch over (m * nb, block) rows, blocks cut per rank.

    A block keeps its first ``kpad`` survivors in lane order and drops the
    rest, as the reference's pack does: block top-k's threshold keeps ties,
    so a block can hold more than k (bf16 residuals do), and the records,
    the wire bytes and every receiver's (and the sender's own) reference
    are then those of the kept survivors."""
    vs, ix = [], []
    for leaf in tree_leaves(tree):
        m = leaf.shape[0]
        flat = leaf.reshape(m, -1).to(torch.float32)
        d = flat.shape[1]
        nb = -(-d // block)
        tiles = F.pad(flat, (0, nb * block - d)).reshape(m * nb, block)
        vals, idx = pack_sparse_blocks(tiles, k=kpad, block=block)
        vs.append(vals.reshape(m, nb, kpad))
        ix.append(idx.reshape(m, nb, kpad))
    return tree_unflatten(tree, vs), tree_unflatten(tree, ix)


def _unpack_leaf(v: torch.Tensor, i: torch.Tensor, like: torch.Tensor, block: int, base=None) -> torch.Tensor:
    """One leaf's (m, nb, kpad) records, every rank's in ONE unpack launch,
    straight into a leaf shaped and typed like ``like`` (plus ``base``)."""
    return unpack_sparse_blocks_into(v.reshape(-1, v.shape[-1]), i.reshape(-1, i.shape[-1]), like, block, base=base)


def _unpack_like(vals_tree: Tree, idx_tree: Tree, like: Tree, block: int) -> Tree:
    """Inverse of `_pack_tree` against a shape/dtype template: packed leaves
    (m, nb, kpad) -> dense leaves shaped and typed like ``like``, every
    rank's records of a leaf in ONE unpack launch.  It gives back the
    kept survivors (all of them where a block held at most kpad) exactly:
    the records carry the values untouched, and f32 -> the leaf's dtype is
    exact for values that started in it."""
    return tree_map(lambda v, i, lk: _unpack_leaf(v, i, lk, block), vals_tree, idx_tree, like)


def _unpack_onto(vals_tree: Tree, idx_tree: Tree, base: Tree, block: int) -> Tree:
    """``base + _unpack_like(vals, idx, base, block)``, each leaf in ONE pass
    of the unpack kernel (records and base read, the sum written: no tile,
    no slice, no separate add)."""
    return tree_map(lambda v, i, b: _unpack_leaf(v, i, b, block, base=b), vals_tree, idx_tree, base)


# ---------------------------------------------------------------------------
# rank-level gossip engines on stacked copies
# ---------------------------------------------------------------------------


class _PpermuteGossiper:
    """Neighbour-copy exchange for shift-structured topologies: rank r keeps
    one copy per schedule shift (the reference point of rank r - shift),
    stacked over the ranks, refreshed only by shifted residuals."""

    def __init__(self, topo: Topology):
        self.schedule = topo.ppermute_schedule

    def init(self, value: Tree) -> tuple:
        return tuple(shift_tree(value, s) for s, _ in self.schedule)

    def mix(self, copies: tuple, own: Tree) -> Tree:
        return mix_received(self.schedule, copies, own)

    def push(self, copies: tuple, q_own: Tree) -> tuple:
        return tuple(
            tree_map(torch.add, c, shift_tree(q_own, s)) for (s, _), c in zip(self.schedule, copies)
        )

    def push_packed(self, copies: tuple, packed, block: int) -> tuple:
        """Fused push: the shifts move the packed (vals, idx) records (nb *
        kpad * 8 bytes a leaf, not the nb * block * 4 of the tile) and the
        receivers unpack them onto their copies, one unpack launch a shift."""
        vals_t, idx_t = packed
        return tuple(
            _unpack_onto(shift_tree(vals_t, s), shift_tree(idx_t, s), c, block)
            for (s, _), c in zip(self.schedule, copies)
        )


class _AllGatherGossiper:
    """General-graph fallback: the gathered reference table (m, ...), the
    same for every rank, updated by gathered residual broadcasts; rank r
    mixes with its row of W - I against it."""

    def __init__(self, topo: Topology, device):
        self.W_minus_I = w_minus_i(torch.as_tensor(topo.W, dtype=torch.float32, device=device))

    def init(self, value: Tree) -> Tree:
        return gather_tree(value)

    def mix(self, table: Tree, own: Tree) -> Tree:
        return mix_gathered(self.W_minus_I, table, own)

    def push(self, table: Tree, q_own: Tree) -> Tree:
        return tree_map(torch.add, table, gather_tree(q_own))

    def push_packed(self, table: Tree, packed, block: int) -> Tree:
        """Fused push: the gather moves packed (vals, idx) records; the
        (m, nb, kpad) record table is unpacked onto the table in one launch."""
        vals_t, idx_t = packed
        return _unpack_onto(gather_tree(vals_t), gather_tree(idx_t), table, block)


def _gossiper(topo: Topology, device):
    if topo.ppermute_schedule is not None:
        return _PpermuteGossiper(topo)
    return _AllGatherGossiper(topo, device)


# ---------------------------------------------------------------------------
# the device-executed C2DFB round
# ---------------------------------------------------------------------------


def _device_inner_loop(
    state: InnerState,
    generator,
    grad_fn,
    gossip,
    compressor: Compressor,
    gamma: float,
    eta: float,
    K: int,
    fused: tuple[int, int] | None = None,
):
    """Algorithm 2 on every rank: K compressed-GT steps where the reference
    mixing reads neighbour COPIES and each step's residual broadcast is an
    executed exchange.  Mirrors `inner_loop.inner_apply` step for step (same
    compressor calls, same update order).  Returns the state and the
    per-step payload stacks ``(q_d, q_s)`` (leaves (K, m, ...)) for the
    host's wire metering.

    With ``fused=(block, kpad)`` each residual is packed on the device right
    after compression (`_pack_tree`): the exchange moves only the records,
    every receiver (and the sender's own reference update) applies the
    unpacked form (`_unpack_onto`: one pass adds it to the copy or
    reference), bit-exact with the dense path for <= kpad survivors a
    block (past kpad a block's last survivors are dropped, as the
    reference drops them), and the payload stacks are the packed ``(vals,
    idx)`` pairs."""
    copies_d = gossip.init(state.d_hat)
    copies_s = gossip.init(state.s_hat)

    def broadcast(copies, q):
        """Push one compressed residual; returns (copies, wire payload)."""
        if fused is None:
            return gossip.push(copies, q), q
        block, kpad = fused
        packed = _pack_tree(q, block, kpad)
        return gossip.push_packed(copies, packed, block), packed

    def apply(hat, pay):
        """The sender's own reference update ``hat + q``: with the fused
        exchange, its records unpacked onto ``hat`` as every receiver's are
        (a -0.0 residual arrives as +0.0, as in the reference)."""
        if fused is None:
            return tree_map(torch.add, hat, pay)
        return _unpack_onto(*pay, hat, fused[0])

    pays_d, pays_s = [], []
    for _ in range(K):
        mix_d = gossip.mix(copies_d, state.d_hat)
        d_new = tree_map(lambda d, md, s: d + gamma * md - eta * s, state.d, mix_d, state.s)
        q_d = inner_transmit(compressor, generator, d_new, state.d_hat)
        copies_d, pay_d = broadcast(copies_d, q_d)
        d_hat_new = apply(state.d_hat, pay_d)

        g_new = grad_fn(d_new)
        mix_s = gossip.mix(copies_s, state.s_hat)
        s_new = tree_map(
            lambda s, ms, gn, gp: s + gamma * ms + gn - gp, state.s, mix_s, g_new, state.g_prev
        )
        q_s = inner_transmit(compressor, generator, s_new, state.s_hat)
        copies_s, pay_s = broadcast(copies_s, q_s)
        s_hat_new = apply(state.s_hat, pay_s)

        state = InnerState(d=d_new, d_hat=d_hat_new, s=s_new, s_hat=s_hat_new, g_prev=g_new)
        pays_d.append(pay_d)
        pays_s.append(pay_s)
    return state, (_stack(pays_d), _stack(pays_s))


def make_device_round(
    problem: BilevelProblem,
    topo: Topology,
    cfg,
    mesh: NodeMesh,
    fused: bool = False,
):
    """The executed C2DFB round on ``mesh``: `c2dfb.c2dfb_round_core`'s
    update order with every gossip exchange executed between the ranks.
    Returns ``fn(x, s_x, u_prev, inner_y, inner_z, generator) -> (x, s_x,
    u_new, inner_y, inner_z, (q_y, q_z))`` on node-stacked trees; the
    payload stacks carry every inner message for wire metering.  The
    problem's oracles are the stacked ones (each rank's gradient from its
    own data shard).

    ``fused=True`` (block-sparse compressors only) fuses the pack kernel
    into the exchange: inner residuals are compressed AND packed on the
    device, the exchanges move the records, and the payload stacks are
    ``(vals, idx)`` pairs with leaves (K, m, nb, kpad), metered by
    `wire.encode_packed_records_chunked` without the dense tree ever
    reaching the host."""
    if mesh.m != topo.m:
        raise ValueError(f"mesh has {mesh.m} ranks but the topology has {topo.m} nodes")
    compressor = cfg.make_compressor()
    pack_spec = fused_pack_spec(compressor) if fused else None
    gossip = _gossiper(topo, mesh.device)

    def round_fn(x, s_x, u_prev, inner_y, inner_z, generator):
        # ---- outer model update (dense broadcast + tracked descent) --------
        mix_x = mix_delta_shard(topo, x)
        x_new = tree_map(lambda x_, mx, s: x_ + cfg.gamma_out * mx - cfg.eta_out * s, x, mix_x, s_x)

        # ---- inner loops on the new x ---------------------------------------
        grad_h = problem.grad_y_h(cfg.lam)
        grad_g = problem.grad_y_g()
        gy = lambda d: grad_h(d, x_new)  # noqa: E731
        gz = lambda d: grad_g(d, x_new)  # noqa: E731
        inner_y = refresh_tracker(inner_y, gy)
        inner_z = refresh_tracker(inner_z, gz)
        inner_y, q_y = _device_inner_loop(
            inner_y, generator, gy, gossip, compressor, cfg.gamma_in, cfg.eta_in_y, cfg.K, pack_spec
        )
        inner_z, q_z = _device_inner_loop(
            inner_z, generator, gz, gossip, compressor, cfg.gamma_in, cfg.eta_in, cfg.K, pack_spec
        )

        # ---- hypergradient + tracker update ---------------------------------
        u_new = problem.hyper_grad(x_new, inner_y.d, inner_z.d, cfg.lam)
        mix_s = mix_delta_shard(topo, s_x)
        s_x_new = tree_map(
            lambda s, ms, un, up: s + cfg.gamma_out * ms + un - up, s_x, mix_s, u_new, u_prev
        )
        return x_new, s_x_new, u_new, inner_y, inner_z, (q_y, q_z)

    return round_fn


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------


class DeviceTransport(Transport):
    """Executed transport over a node mesh (every rank on one device).

    Parameters
    ----------
    mesh       : a `NodeMesh` (`mesh_for_nodes`); None builds one at `bind`
                 (on the run's device under ``run(transport=)``)
    link       : profile name / `LinkModel` the internal fabric prices the
                 EXECUTED byte counts with ("zero": in-process exchanges get
                 no pretend latency; "wan" / "geo" ask what this executed
                 traffic would cost on that wire)
    straggler  : `StragglerModel` or kind string for the pricing fabric
    axis       : the name of the mesh axis the nodes lie on.  The
                 reference's mesh is one device a node along a named axis,
                 and its collectives run over that axis; here every rank
                 is a row on one device and no collective runs, so the
                 name is kept (``self.axis``) and used for nothing else.
    verify     : check decode(encode(payload)) message for message
                 (bit-exact; KernelQuant to 1 ulp), as the reference does.
                 ``verify=False`` skips the check in all three meters;
                 the bytes, the delivered payloads and the state do not
                 change.
    fused      : run the FUSED round (`make_device_round(fused=True)`):
                 residuals are compressed and packed on the device and the
                 exchanges move the records; block-sparse compressors only.
                 Implies chunked metering (``chunk`` defaults to 1 << 16).
    chunk      : when set, meter every message with the CHUNKED tree codec
                 (`wire.encode_tree_chunked`); executed bytes then equal
                 `wire.measure_tree_bytes_chunked`.  None keeps the per-leaf
                 format of `wire.measure_tree_bytes`.

    After a run with ``obs=``, ``cost`` holds the `RoundCost` of its round
    body, counted on round 0: one rank's ``flops``, ``hbm_bytes`` and
    ``collective_bytes`` (what the reference's bench reads from its
    round-cost memo).  None before such a run.
    """

    def __init__(
        self,
        mesh: NodeMesh | None = None,
        link="zero",
        straggler: StragglerModel | str | None = None,
        compute_s: float = 0.0,
        seed: int = 0,
        trace=None,
        axis: str = "nodes",
        verify: bool = True,
        fused: bool = False,
        chunk: int | None = None,
        **straggler_kw,
    ):
        self.mesh = mesh
        self.axis = axis
        self.verify = verify
        if fused and chunk is None:
            chunk = 1 << 16
        if chunk is not None and chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.fused = fused
        self.chunk = chunk
        self._link = link
        if isinstance(straggler, str):
            straggler = StragglerModel(kind=straggler, **straggler_kw)
        self._straggler = straggler
        self._compute_s = compute_s
        self._seed = seed
        self._trace = trace
        self.fabric: NetworkFabric | None = None
        self.cost = None

    # ------------------------------------------------------------------
    def bind(self, topo: Topology, device: str | torch.device | None = None) -> "DeviceTransport":
        """Attach the graph; build the mesh on ``device`` (``cuda`` unless
        given) when the transport has none."""
        if self.fabric is not None:
            if self.fabric.topo.m != topo.m or self.fabric.topo.name != topo.name:
                raise ValueError(
                    f"DeviceTransport is bound to {self.fabric.topo.name!r} "
                    f"(m={self.fabric.topo.m}) but was asked to run on "
                    f"{topo.name!r} (m={topo.m})"
                )
            return self
        if self.mesh is None:
            self.mesh = mesh_for_nodes(topo.m, device)
        if self.mesh.m != topo.m:
            raise ValueError(
                f"mesh has {self.mesh.m} ranks but the topology has {topo.m} "
                "nodes: DeviceTransport places exactly one node a rank"
            )
        self.fabric = NetworkFabric(
            topo,
            link=self._link,
            straggler=self._straggler,
            compute_s=self._compute_s,
            seed=self._seed,
            trace=self._trace,
        )
        return self

    @property
    def executes(self) -> bool:
        return True

    def shard(self, tree):
        """Place a node-stacked tree (or state) on the mesh: row r of every
        leaf is rank r's slice."""
        self._require_bound()
        return _on(tree, self.mesh.device)

    # ------------------------------------------------------------------
    # wire round trip + verification (host)
    # ------------------------------------------------------------------
    def _roundtrip(self, arrs: list, compressor: Compressor | None):
        """encode -> decode each node's message (``arrs``: the payload's
        leaves as host arrays, leading axis m) with the wire codec and verify
        the receipt against the executed payload.  Returns the decoded leaves
        (what receivers apply) and the per-node executed message bytes:
        `wire.measure_tree_bytes` of each slice by construction."""
        comp = compressor if compressor is not None else C.Identity()
        codec = codec_for(comp)
        exact = not isinstance(comp, C.KernelQuant)
        out = [np.empty_like(a, dtype=np.float32) for a in arrs]

        def node(i):
            nbytes = 0
            for li, a in enumerate(arrs):
                payload = codec.encode(a[i].reshape(-1))
                nbytes += len(payload)
                dec = codec.decode(payload).reshape(a[i].shape)
                if self.verify:
                    sent = a[i].astype(np.float32)
                    if exact and not np.array_equal(dec, sent):
                        raise AssertionError(
                            f"wire codec round-trip mismatch on node {i}, leaf {li}: the "
                            "executed payload did not survive encode->decode bit-exactly"
                        )
                    if not exact and not np.allclose(dec, sent, rtol=1e-5, atol=0):
                        raise AssertionError(
                            f"KernelQuant wire round-trip drifted past 1-ulp tolerance on node {i}, leaf {li}"
                        )
                out[li][i] = dec
            return nbytes

        return out, tuple(_per_node(node, arrs[0].shape[0]))

    def exchange(
        self,
        payload: Tree,
        compressor: Compressor | None = None,
        round_idx: int = 0,
        phase_idx: int = 0,
        label: str = "exchange",
        edges=None,
    ) -> tuple[Tree, ExchangeReport]:
        self._require_bound()
        edges = self._edge_set(edges)
        t0 = time.perf_counter()
        leaves = tree_leaves(payload)
        decoded, node_bytes = self._roundtrip([_host(v) for v in leaves], compressor)
        edge_bytes = {(i, j): node_bytes[i] for (i, j) in edges}
        wire_bytes = int(sum(edge_bytes.values()))
        # every rank receives every slice: the gathered table, on the mesh
        delivered = tree_unflatten(
            payload,
            [torch.from_numpy(d).to(device=self.mesh.device, dtype=v.dtype) for d, v in zip(decoded, leaves)],
        )
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        wall = time.perf_counter() - t0
        duration = self._price_phase(edge_bytes, round_idx, phase_idx)
        return delivered, ExchangeReport(
            node_bytes=node_bytes,
            wire_bytes=wire_bytes,
            duration_s=duration,
            wall_s=wall,
            label=label,
        )

    def _roundtrip_chunked(self, arrs: list, compressor: Compressor | None) -> tuple:
        """Chunked twin of `_roundtrip`: each node's message through
        `wire.encode_tree_chunked` (per-chunk headers) and back, verified
        bit-exactly.  Returns per-node executed bytes
        (`measure_tree_bytes_chunked` of each slice by construction)."""
        comp = compressor if compressor is not None else C.Identity()
        codec = codec_for(comp)

        def node(i):
            slc = [a[i] for a in arrs]
            payloads = codec.encode_tree_chunked(slc, self.chunk)
            if not self.verify:
                return sum(len(p) for p in payloads)
            got = np.concatenate([codec.decode(p) for p in payloads])
            sent = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in slc])
            if not np.array_equal(got, sent):
                raise AssertionError(
                    f"chunked wire round-trip mismatch on node {i}: the executed "
                    "payload did not survive encode->decode bit-exactly"
                )
            return sum(len(p) for p in payloads)

        return tuple(_per_node(node, arrs[0].shape[0]))

    def _packed_node_bytes(self, vals_leaves: list, idx_leaves: list, leaf_sizes: list, block: int) -> tuple:
        """Executed bytes of one inner step's per-node messages built
        DIRECTLY from the packed records (host arrays, leaves (m, nb,
        kpad)): the fused path's codec truth, byte-identical to
        chunk-encoding the dense tree, which never reaches the host."""
        chunk = self.chunk if self.chunk is not None else 1 << 16

        def node(i):
            vlist = [v[i] for v in vals_leaves]
            ilist = [ix[i] for ix in idx_leaves]
            payloads = wire.encode_packed_records_chunked(vlist, ilist, leaf_sizes, block, chunk)
            if not self.verify:
                return sum(len(p) for p in payloads)
            dec = np.concatenate([wire.SparseCodec().decode(p) for p in payloads])
            ref = wire.scatter_packed_records(vlist, ilist, leaf_sizes, block)
            if not np.array_equal(dec, ref):
                raise AssertionError(
                    f"packed-record wire round-trip mismatch on node {i}: decoded "
                    "chunks disagree with the scattered records"
                )
            return sum(len(p) for p in payloads)

        return tuple(_per_node(node, vals_leaves[0].shape[0]))

    # ------------------------------------------------------------------
    def meter_round(
        self,
        outer_payloads,
        inner_stacks,
        compressor: Compressor,
        round_idx: int,
        packed: bool = False,
        inner_like: Tree | None = None,
    ) -> dict:
        """Wire-account one executed round: every message of the round makes
        the codec round trip (verification included) and the EXECUTED byte
        counts are priced on the internal fabric, advancing its clock.

        ``outer_payloads``: [(label, dense node-stacked tree), ...];
        ``inner_stacks``: [(tag, (q_d, q_s) with (K, m, ...) leaves), ...],
        or with ``packed=True`` (the fused round) ``(vals, idx)`` record
        pairs with leaves (K, m, nb, kpad), metered against ``inner_like``
        (one node's residual tree, for its leaf sizes).  Returns
        {"sim_seconds", "wire_bytes", "node_bytes"}, ``node_bytes`` mapping
        each phase label to the per-node executed message bytes.

        Every byte here is codec truth, the dense outer broadcasts included
        (the dense codec's 5-byte header a leaf), where `c2dfb.round_phases`
        prices the outer phases headerless, as the reference does too."""
        self._require_bound()
        edges = self._edge_set(None)
        phases, labels, per_phase_nb = [], [], {}

        def add_phase(label, nb):
            phases.append({(i, j): nb[i] for (i, j) in edges})
            labels.append(label)
            per_phase_nb[label] = nb

        def dense_nb(arrs, comp):
            if self.chunk is None:
                return self._roundtrip(arrs, comp)[1]
            return self._roundtrip_chunked(arrs, comp)

        def step(stack, k):
            return [_host(v[k]) for v in tree_leaves(stack)]

        for label, tree in outer_payloads:
            add_phase(label, dense_nb([_host(v) for v in tree_leaves(tree)], None))
        if packed:
            if inner_like is None:
                raise ValueError(
                    "packed metering needs inner_like (one node's residual tree template) to recover leaf sizes"
                )
            block, _ = fused_pack_spec(compressor)
            leaf_sizes = [math.prod(v.shape) for v in tree_leaves(inner_like)]
            for tag, stacks in inner_stacks:
                K = tree_leaves(stacks[0][0])[0].shape[0]
                for k in range(K):
                    for name, (vals_t, idx_t) in (("d", stacks[0]), ("s", stacks[1])):
                        add_phase(
                            f"{tag}/in{k}/{name}",
                            self._packed_node_bytes(step(vals_t, k), step(idx_t, k), leaf_sizes, block),
                        )
        else:
            for tag, (q_d, q_s) in inner_stacks:
                K = tree_leaves(q_d)[0].shape[0]
                for k in range(K):
                    for name, stack in (("d", q_d), ("s", q_s)):
                        add_phase(f"{tag}/in{k}/{name}", dense_nb(step(stack, k), compressor))
        rep = self.fabric.simulate_round(phases, round_idx, labels=labels)
        return {
            "sim_seconds": rep["sim_seconds"],
            "wire_bytes": rep["wire_bytes"],
            "node_bytes": per_phase_nb,
        }
