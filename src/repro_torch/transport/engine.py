"""Transport-generic C2DFB driver (``repro.transport.engine``'s
counterpart).

`run_c2dfb_transport` is what ``c2dfb.run(transport=...)`` dispatches to:

* a non-executing transport (`SimTransport`) routes straight back into the
  priced-simulation path with its wrapped fabric, bit for bit the same as
  calling ``run(fabric=...)``: sync, the async engine and its compiled
  runtime, topology schedules;
* an executing transport (`DeviceTransport`) drives `make_device_round`
  round by round: every gossip exchange runs between the ranks of its
  mesh, and after each round the executed payload stacks make the
  wire-codec round trip on the host (`DeviceTransport.meter_round`), so
  ``wire_bytes`` / ``sim_seconds`` are measured on the real messages.  The
  metric keys are those of the synchronous ``run`` (plus ``wall_seconds``
  and ``meter_seconds``); the device loop's metrics are host numpy
  arrays, one entry a round, as the reference's are.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.bilevel_problem import BilevelProblem
from repro_torch.core.c2dfb import C2DFBState, init_state, run_device
from repro_torch.core.topology import Topology
from repro_torch.core.types import (
    Tree,
    consensus_error,
    node_consensus_dist,
    node_mean,
    tree_count,
    tree_map,
    tree_sq_norm,
)
from repro_torch.obs.compute import RoundCost, c2dfb_oracle_calls, memory_peak_bytes, round_cost
from repro_torch.obs.core import as_obs
from repro_torch.transport.base import Transport
from repro_torch.transport.device import DeviceTransport, make_device_round


def _numpy(tree):
    """A payload stack (tensors, dicts, lists, (vals, idx) tuples) as host
    numpy; a bf16 leaf comes as f32, which holds it exactly (numpy has no
    bf16)."""
    if isinstance(tree, tuple):
        return tuple(_numpy(t) for t in tree)
    return tree_map(lambda v: (v.detach().float() if v.dtype == torch.bfloat16 else v.detach()).cpu().numpy(), tree)


def run_c2dfb_transport(
    problem: BilevelProblem,
    topo: Topology,
    cfg,
    x0: Tree,
    y0: Tree,
    T: int,
    generator,
    transport: Transport,
    device: str | torch.device | None = None,
    schedule=None,
    async_mode: str | None = None,
    staleness_bound: int = 2,
    version_rule: str = "common",
    ledger=None,
    mixing_damping: str = "none",
    damping_decay: float = 0.5,
    return_payloads: bool = False,
    compiled: bool = False,
    obs=None,
) -> tuple[C2DFBState, dict]:
    """T outer rounds of C2DFB over a `Transport` (see the module
    docstring).  ``return_payloads`` additionally keeps the executed
    per-round inner payload stacks (host numpy) in ``metrics["payloads"]``
    (device backend only).  ``obs`` streams the shared per-round records
    from whichever backend runs: the SimTransport branch hands it to
    ``run``; the device loop emits ``engine="transport-device"`` round and
    node rows with executed byte counts.

    Features the device backend does not execute raise
    ``NotImplementedError`` naming the feature (``async_mode``,
    ``version_rule``, ``compiled``, ``schedule``), so callers can branch on
    capability with one except clause; ``mixing_damping`` raises a
    ValueError (on synchronous rounds it would be a silent no-op)."""
    if not transport.executes:
        from repro_torch.core.c2dfb import run

        transport.bind(topo)
        return run(
            problem, topo, cfg, x0, y0, T, generator, device=device,
            schedule=schedule, fabric=transport.fabric, obs=obs,
            async_mode=async_mode, staleness_bound=staleness_bound,
            version_rule=version_rule, ledger=ledger,
            mixing_damping=mixing_damping, damping_decay=damping_decay,
            compiled=compiled,
        )

    if async_mode is not None:
        raise NotImplementedError(
            "DeviceTransport does not support async_mode: it executes "
            "synchronous rounds; async needs the priced SimTransport"
        )
    if version_rule != "common":
        raise NotImplementedError(
            "DeviceTransport does not support version_rule: it executes "
            "synchronous rounds, and version_rule selects an ASYNC edge-version "
            "protocol — use SimTransport (or a bare fabric) with async_mode"
        )
    if compiled:
        raise NotImplementedError(
            "DeviceTransport does not support compiled: that is the async "
            "runtime's scheduler replay and graph replays, and the device "
            "backend executes rounds eagerly — use SimTransport (or a bare "
            "fabric) with async_mode for the compiled path"
        )
    if schedule is not None:
        raise NotImplementedError(
            "DeviceTransport does not support schedule: time-varying "
            "topologies are not executed — run schedules through SimTransport"
        )
    if mixing_damping != "none":
        raise ValueError(
            "mixing_damping is a staleness policy; the device backend is "
            "synchronous (all ages zero) so damping would be a silent no-op"
        )
    if not isinstance(transport, DeviceTransport):
        raise TypeError(f"no executed round for {type(transport).__name__}")
    device = run_device(problem, x0, y0, device)
    transport.bind(topo, device=device)
    if transport.mesh.device.type != device.type:
        raise ValueError(f"the transport's mesh lies on {transport.mesh.device}, the run on {device}")
    obs = as_obs(obs)
    state = init_state(problem, cfg, x0, y0)
    compressor = cfg.make_compressor()
    fused = transport.fused
    round_fn = make_device_round(problem, topo, cfg, transport.mesh, fused=fused)
    # one node's inner-residual template: leaf sizes for packed metering
    inner_like = tree_map(lambda v: v[0], state.inner_y.d)
    parts = tuple(
        transport.shard(p) for p in (state.x, state.s_x, state.u_prev, state.inner_y, state.inner_z)
    )
    m = topo.m
    outer_bytes = 2 * tree_count(state.x) * 4 * m
    deg = [len(nbrs) for nbrs in topo.neighbors]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cost = mem0 = fleet_oracles = None
    rows: list[dict] = []
    payload_log: list = []
    for t in range(T):
        x_prev, s_prev = parts[0], parts[1]
        t0 = time.perf_counter()
        if obs is not None and t == 0:
            # the executed round body's cost, counted on round 0 itself.  The
            # reference lowers one SPMD module for the nodes resident on ONE
            # mesh device (one node a device); the port's mesh holds every
            # rank on one device, so the rows carry one rank's share of the
            # FLOPs and dot bytes.  The exchanges report one rank's
            # collective bytes already: not divided.
            with obs.span("cost_analysis", engine="transport-device"):
                out, fleet = round_cost(
                    round_fn, *parts, generator,
                    expected_oracles=c2dfb_oracle_calls(cfg),
                    label="c2dfb/device-fused" if fused else "c2dfb/device",
                )
            cost = transport.cost = RoundCost(flops=fleet.flops / m, hbm_bytes=fleet.hbm_bytes / m,
                                              collective_bytes=fleet.collective_bytes)
            fleet_oracles = {k: v * m for k, v in c2dfb_oracle_calls(cfg).items()}
            mem0 = memory_peak_bytes(device)
        else:
            out = round_fn(*parts, generator)
        sync()
        wall = time.perf_counter() - t0
        x, s_x, u_new, inner_y, inner_z, (q_y, q_z) = out
        parts = (x, s_x, u_new, inner_y, inner_z)

        t1 = time.perf_counter()
        rep = transport.meter_round(
            [("out/x", x_prev), ("out/s_x", s_prev)],
            [("y", q_y), ("z", q_z)],
            compressor,
            t,
            packed=fused,
            inner_like=inner_like if fused else None,
        )
        meter_wall = time.perf_counter() - t1
        row = {
            "hypergrad_norm": np.sqrt(float(tree_sq_norm(node_mean(u_new)))),
            "x_consensus_err": float(consensus_error(x)),
            "sx_consensus_err": float(consensus_error(s_x)),
            "y_consensus_err": float(consensus_error(inner_y.d)),
            "y_compress_err": float(tree_sq_norm(tree_map(torch.sub, inner_y.d, inner_y.d_hat))),
            "z_consensus_err": float(consensus_error(inner_z.d)),
            # broadcast accounting, as the simulator's on-device count: each
            # inner message once a sender (the meter's executed bytes, codec
            # truth) plus the analytic dense outer term of c2dfb_round_core
            "measured_bytes": sum(
                sum(nb) for label, nb in rep["node_bytes"].items() if not label.startswith("out/")
            ) + outer_bytes,
            "wire_bytes": int(rep["wire_bytes"]),
            "sim_seconds": float(rep["sim_seconds"]),
            "wall_seconds": wall,
            # host wire metering (codec encode and verify of every message):
            # the fused path assembles records here instead of dense payloads
            "meter_seconds": meter_wall,
            "x_node_dist": node_consensus_dist(x).float().cpu().numpy(),
        }
        rows.append(row)
        if obs is not None:
            _emit_rows(obs, t, row, rep["node_bytes"], deg, wall, cost, fleet_oracles, mem0)
        if return_payloads:
            payload_log.append({"y": _numpy(q_y), "z": _numpy(q_z), "node_bytes": rep["node_bytes"]})

    x, s_x, u_new, inner_y, inner_z = parts
    final = C2DFBState(x=x, s_x=s_x, u_prev=u_new, inner_y=inner_y, inner_z=inner_z, t=state.t + T)
    metrics: dict = {k: np.asarray([r[k] for r in rows]) for k in (rows[0] if rows else {})}
    if return_payloads:
        metrics["payloads"] = payload_log
    return final, metrics


def _emit_rows(obs, t, row, node_bytes, deg, wall, cost, fleet_oracles, mem0) -> None:
    """Round ``t``'s fleet record and its m node records on the device
    backend.  Each sender's message is priced once a directed edge, so a
    stream's wire share is sum_i deg(i) * node_bytes[i]: the three streams
    ("outer", "y", "z", from the phase labels "out/x", "out/s_x",
    "{y,z}/in{k}/{d,s}") sum to the round's wire bytes exactly, and so do
    the node rows' wire shares."""
    m = len(deg)
    w1 = obs.hostspans.now()
    obs.hostspans.add(f"round[{t}]", w1 - wall, w1)

    def stream(prefix):
        return int(sum(
            sum(d * b for d, b in zip(deg, nb)) for label, nb in node_bytes.items() if label.startswith(prefix)
        ))

    obs.round(
        "transport-device", t, row,
        bytes_by_stream={"outer": stream("out/"), "y": stream("y/"), "z": stream("z/")},
        wall_seconds=wall,
        oracle_calls=fleet_oracles,
        compute_flops=cost.flops if cost is not None else None,
        hbm_bytes=cost.hbm_bytes if cost is not None else None,
        memory_peak_bytes=mem0 if t == 0 else None,
    )

    def node_stream(prefix, i):
        return int(sum(nb[i] for label, nb in node_bytes.items() if label.startswith(prefix)))

    for i in range(m):
        split = {"outer": node_stream("out/", i), "y": node_stream("y/", i), "z": node_stream("z/", i)}
        nbytes = sum(split.values())
        obs.node(
            "transport-device", t, i,
            {
                "x_dist": row["x_node_dist"][i],
                "node_bytes": nbytes,
                "wire_bytes": deg[i] * nbytes,
                "staleness_max": 0,
                "staleness_mean": 0.0,
                "compute_flops": cost.flops / m if cost is not None else None,
            },
            bytes_by_stream=split,
        )
