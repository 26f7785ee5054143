"""The port's DeviceTransport against the reference's OWN DeviceTransport,
run live once in a subprocess with 8 forced host devices (one node a
device), as tests/test_transport.py runs it:

* ring (neighbour shifts) and star (all-gather), dense top-k and dense and
  fused block top-k: states within rtol 1e-4 / atol 1e-6; every node's
  executed bytes on every step and round, ``wire_bytes`` and
  ``measured_bytes`` equal;
* ``compute_flops`` / ``hbm_bytes`` of the ``transport-device`` rows: the
  reference counts the SPMD module of one mesh device (one node); the port,
  whose mesh holds every rank on one device, gives one rank's share of its
  round and equals it on the dense runs.  On the fused runs the reference
  also counts the one-hot matmuls of its interpret-mode pack and unpack,
  which the port's kernels do not do; the port's fused count is its dense
  count (ROADMAP §C);
* ``collective_bytes``, the round's collectives one mesh device receives
  (the reference's HLO walk, dumped from its round-cost memo): equal on
  all six runs, 4,800 / 4,800 / 25,920 bytes on the ring and 9,600 /
  9,600 / 51,840 on the star (dense top-k, dense and fused block top-k),
  and equal to the closed form `device_collective_bytes`;
* the ``BENCH_transport.json`` gate config (m = 4, K = 4, T = 3, n = 200,
  p = 30, ring, wan, top-k 0.3): the port's sim and device ``wire_bytes``
  equal the reference's live figures (the committed 147,456 and 147,696
  came from jax 0.4.37);
* a fused run whose blocks hold more than kpad survivors: the port drops
  the survivors past kpad as the reference does, every byte count equal;
* ``verify=False`` and ``axis=``, which both packages take: the meters skip
  the decode check, and the bytes and the state are ``verify=True``'s
  and the reference's unverified run's;
* the fused round on ``run()``'s own round-t states, round by round (the
  reference's states, stepped live in process): run()'s round records its
  top-k selections, the fused round keeps them, and every row where its
  own choice parts is a near-tie (`repro_torch.core.selection`); then
  the two rounds agree within rtol 1e-4 / atol 1e-6, and the fused round
  equals c2dfb_round with the exchange's mixing form in value.

About 60 s on one worker, most of it the reference's subprocess."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import c2dfb as J
from repro.core import topology as jtopo
from repro.data import bilevel_tasks as jtasks
from repro_torch.async_gossip.compiled import _tensors
from repro_torch.core import c2dfb as pc2dfb
from repro_torch.core import inner_loop as pinner
from repro_torch.core import selection
from repro_torch.core.gossip import mix_delta_shard
from repro_torch.core import topology as ptopo
from repro_torch.core.c2dfb import C2DFBConfig, c2dfb_round, run
from repro_torch.core import types as ptypes
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.net import make_fabric
from repro_torch.obs import MemorySink
from repro_torch.obs.compute import device_collective_bytes
from repro_torch.transport import DeviceTransport, SimTransport, make_device_round, mesh_for_nodes, run_c2dfb_transport

RTOL, ATOL = 1e-4, 1e-6
M, T = 4, 3
TASK = dict(m=M, n=80, p=12, c=3, h=0.5, seed=0)
CFGS = {
    "topk": dict(K=3, compressor="topk", comp_ratio=0.3, gamma_in=0.3, eta_in=0.3),
    "block": dict(K=3, compressor="block_topk", comp_ratio=0.3, gamma_in=0.3, eta_in=0.3, comp_block=128),
}
RUNS = [(topo, cfg, fused) for topo in ("ring", "star") for cfg, fused in (("topk", False), ("block", False), ("block", True))]
UNVERIFIED = [("ring", "topk", False), ("ring", "block", True)]
# a fused run whose blocks hold more than kpad survivors: y0 = 0 and every
# node's documents of one class (h = 1), so each node's first gradient of
# y is equal across the classes it has no documents of, and the kernel's
# threshold keeps those ties past k = kpad = 128 of a 256-block
TIE = dict(task=dict(m=M, n=80, p=32, c=8, h=1.0, seed=0), T=1,
           cfg=dict(K=2, compressor="kernel_topk", comp_ratio=0.5, comp_block=256, gamma_in=0.3, eta_in=0.3))
GATE_TASK = dict(m=M, n=200, p=30, c=5, h=0.8, seed=0)
GATE_CFG = dict(lam=10.0, eta_out=0.3, gamma_out=0.5, eta_in=0.3, gamma_in=0.3, K=4, compressor="topk", comp_ratio=0.3)

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import json, sys
import jax
import numpy as np
jax.config.update("jax_default_matmul_precision", "highest")
from repro.core.c2dfb import C2DFBConfig, run
from repro.core.topology import make_topology, ring
from repro.data.bilevel_tasks import coefficient_tuning_task
from repro.net import make_fabric
from repro.obs import MemorySink
from repro.transport import DeviceTransport, SimTransport
from repro.transport.engine import run_c2dfb_transport
from repro.obs.compute import _COST_CACHE, reset_cost_cache

spec = json.loads(sys.argv[1])
key = jax.random.PRNGKey(0)
b = coefficient_tuning_task(**spec["task"])
out = {"x0": np.asarray(b.x0).tolist(), "y0": np.asarray(b.y0).tolist(), "runs": {}}
for topo_name, cfg_name, fused in spec["runs"]:
    topo = make_topology(topo_name, spec["task"]["m"])
    sink = MemorySink()
    reset_cost_cache()
    st, mets = run_c2dfb_transport(b.problem, topo, C2DFBConfig(**spec["cfgs"][cfg_name]), b.x0, b.y0, spec["T"], key,
                                   DeviceTransport(fused=fused), obs=sink, return_payloads=True)
    rows = sink.rows(kind="round")
    out["runs"][f"{topo_name}/{cfg_name}/{fused}"] = {
        "state": {f: np.asarray(v).tolist() for f, v in
                  [("x", st.x), ("s_x", st.s_x), ("y", st.inner_y.d), ("y_hat", st.inner_y.d_hat),
                   ("z", st.inner_z.d), ("z_s_hat", st.inner_z.s_hat)]},
        "wire_bytes": [int(v) for v in mets["wire_bytes"]],
        "measured_bytes": [int(v) for v in mets["measured_bytes"]],
        "hypergrad_norm": [float(v) for v in mets["hypergrad_norm"]],
        "compute_flops": [r["compute_flops"] for r in rows],
        "hbm_bytes": [r["hbm_bytes"] for r in rows],
        "node_compute_flops": [r["compute_flops"] for r in sink.rows(kind="node")],
        "node_bytes": [[r["node_bytes"] for r in sink.rows(kind="node") if r["round"] == t] for t in range(spec["T"])],
        "phase_node_bytes": [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in mets["payloads"]],
        "bytes_by_stream": [r["bytes_by_stream"] for r in rows],
        "collective_bytes": [c.collective_bytes for c in _COST_CACHE.values()],
    }
unverified = {}
for topo_name, cfg_name, fused in spec["unverified"]:
    st, mets = run_c2dfb_transport(b.problem, make_topology(topo_name, spec["task"]["m"]),
                                   C2DFBConfig(**spec["cfgs"][cfg_name]), b.x0, b.y0, spec["T"], key,
                                   DeviceTransport(fused=fused, verify=False, axis="nodes"), return_payloads=True)
    unverified[f"{topo_name}/{cfg_name}/{fused}"] = {
        "x": np.asarray(st.x).tolist(),
        "wire_bytes": [int(v) for v in mets["wire_bytes"]],
        "phase_node_bytes": [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in mets["payloads"]],
    }
out["unverified"] = unverified
g = coefficient_tuning_task(**spec["gate_task"])
out["gate_x0"], out["gate_y0"] = np.asarray(g.x0).tolist(), np.asarray(g.y0).tolist()
gate = {}
for name in ("sim", "device"):
    tr = SimTransport(make_fabric(ring(4), profile="wan", seed=0)) if name == "sim" else DeviceTransport(link="wan", seed=0)
    _, mets = run(g.problem, ring(4), C2DFBConfig(**spec["gate_cfg"]), g.x0, g.y0, T=3, key=key, transport=tr)
    gate[name] = [int(v) for v in mets["wire_bytes"]]
out["gate"] = gate
tie = spec["tie"]
tb = coefficient_tuning_task(**tie["task"])
sink = MemorySink()
st, mets = run_c2dfb_transport(tb.problem, make_topology("ring", tie["task"]["m"]), C2DFBConfig(**tie["cfg"]), tb.x0,
                               np.zeros_like(tb.y0), tie["T"], key, DeviceTransport(fused=True), obs=sink,
                               return_payloads=True)
out["tie"] = {
    "x0": np.asarray(tb.x0).tolist(),
    "state": {f: np.asarray(v).tolist() for f, v in
              [("x", st.x), ("s_x", st.s_x), ("y", st.inner_y.d), ("y_hat", st.inner_y.d_hat),
               ("z", st.inner_z.d), ("z_s_hat", st.inner_z.s_hat)]},
    "wire_bytes": [int(v) for v in mets["wire_bytes"]],
    "measured_bytes": [int(v) for v in mets["measured_bytes"]],
    "node_bytes": [r["node_bytes"] for r in sink.rows(kind="node")],
    "phase_node_bytes": [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in mets["payloads"]],
}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's device runs, live."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    spec = dict(task=TASK, cfgs=CFGS, runs=RUNS, T=T, gate_task=GATE_TASK, gate_cfg=GATE_CFG, unverified=UNVERIFIED,
                tie=TIE)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, json.dumps(spec)], capture_output=True, text=True, env=env, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _bundle(task, x0, y0):
    b = ptasks.coefficient_tuning_task(**task, device="cpu")
    return dataclasses.replace(
        b, x0=from_numpy(np.asarray(x0, np.float32)), y0=from_numpy(np.asarray(y0, np.float32))
    )


@pytest.fixture(scope="module")
def port(reference):
    b = _bundle(TASK, reference["x0"], reference["y0"])
    out = {}
    for topo_name, cfg_name, fused in RUNS:
        sink = MemorySink()
        tr = DeviceTransport(fused=fused)
        st, mets = run_c2dfb_transport(
            b.problem, ptopo.make_topology(topo_name, M), C2DFBConfig(**CFGS[cfg_name]), b.x0, b.y0, T, None,
            tr, device="cpu", obs=sink, return_payloads=True,
        )
        out[f"{topo_name}/{cfg_name}/{fused}"] = (st, mets, sink, tr)
    return out


NAMES = [f"{t}/{c}/{f}" for t, c, f in RUNS]


@pytest.mark.parametrize("name", NAMES)
def test_states_match_the_reference_device_run(reference, port, name):
    st, mets, _, _ = port[name]
    want = reference["runs"][name]
    got = dict(x=st.x, s_x=st.s_x, y=st.inner_y.d, y_hat=st.inner_y.d_hat, z=st.inner_z.d, z_s_hat=st.inner_z.s_hat)
    for f, v in got.items():
        np.testing.assert_allclose(to_numpy(v), np.asarray(want["state"][f]), rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(mets["hypergrad_norm"], want["hypergrad_norm"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_executed_bytes_equal_the_reference(reference, port, name):
    _, mets, sink, _ = port[name]
    want = reference["runs"][name]
    assert [int(v) for v in mets["wire_bytes"]] == want["wire_bytes"]
    assert [int(v) for v in mets["measured_bytes"]] == want["measured_bytes"]
    nodes = sink.rows(kind="node")
    assert [[r["node_bytes"] for r in nodes if r["round"] == t] for t in range(T)] == want["node_bytes"]
    # every message's node bytes, phase by phase (2 outer + 4K inner a round)
    got = [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in mets["payloads"]]
    assert got == want["phase_node_bytes"] and len(got[0]) == 2 + 4 * CFGS["topk"]["K"]
    assert [r["bytes_by_stream"] for r in sink.rows(kind="round")] == want["bytes_by_stream"]


@pytest.mark.parametrize("name", NAMES)
def test_compute_counts_of_the_device_rows(reference, port, name):
    """Dense runs: the reference's counts of one mesh device's module.  Fused
    runs: the port counts what its dense run counts (B2 and B3 multiply
    nothing), the reference more (its interpret-mode one-hot matmuls)."""
    _, _, sink, _ = port[name]
    rows, nodes = sink.rows(kind="round"), sink.rows(kind="node")
    want = reference["runs"][name]
    dense = reference["runs"][name.replace("/True", "/False")]
    assert [r["compute_flops"] for r in rows] == dense["compute_flops"]
    assert [r["hbm_bytes"] for r in rows] == dense["hbm_bytes"]
    assert [r["compute_flops"] for r in nodes] == dense["node_compute_flops"]
    if name.endswith("/True"):
        assert want["compute_flops"][0] > dense["compute_flops"][0]
        assert want["hbm_bytes"][0] > dense["hbm_bytes"][0]
    else:
        assert [r["compute_flops"] for r in rows] == want["compute_flops"]


# one mesh device's collective bytes a round: ring (2 shifts) and star
# (gathers of m = 4 slices), dense top-k, dense and fused block top-k
COLLECTIVE_BYTES = {"ring": (4_800.0, 4_800.0, 25_920.0), "star": (9_600.0, 9_600.0, 51_840.0)}


@pytest.mark.parametrize("name", NAMES)
def test_collective_bytes_equal_the_reference_and_the_closed_form(reference, port, name):
    """The round's ``collective_bytes`` (counted on round 0, kept on the
    transport) is the reference's HLO walk of one mesh device's module,
    taken live from its round-cost memo: the outer exchange of x and s_x,
    the setup exchange of each inner loop's reference points and the 4K
    residual exchanges, each once a ring shift or m slices a gather, dense
    or as packed records.  It equals `device_collective_bytes` exactly."""
    _, _, _, tr = port[name]
    topo_name, cfg_name, fused = name.split("/")
    fused = fused == "True"
    want = reference["runs"][name]["collective_bytes"]
    assert isinstance(tr.cost.collective_bytes, float)
    assert [tr.cost.collective_bytes] == want
    assert want[0] == COLLECTIVE_BYTES[topo_name][RUNS.index((topo_name, cfg_name, fused)) % 3]
    b = _bundle(TASK, reference["x0"], reference["y0"])
    closed = device_collective_bytes(ptopo.make_topology(topo_name, M), C2DFBConfig(**CFGS[cfg_name]), b.x0, b.y0,
                                     fused)
    assert closed == tr.cost.collective_bytes


def test_gate_config_wire_bytes_equal_the_reference(reference):
    b = _bundle(GATE_TASK, reference["gate_x0"], reference["gate_y0"])
    topo = ptopo.ring(M)
    got = {}
    for name in ("sim", "device"):
        tr = SimTransport(make_fabric(topo, profile="wan", seed=0)) if name == "sim" else DeviceTransport(link="wan", seed=0)
        _, mets = run(b.problem, topo, C2DFBConfig(**GATE_CFG), b.x0, b.y0, T=3, device="cpu", transport=tr)
        got[name] = [int(v) for v in mets["wire_bytes"]]
    assert got == reference["gate"]


@pytest.mark.parametrize("topo_name,cfg_name,fused", UNVERIFIED)
def test_unverified_meters_give_the_verified_bytes_and_state(reference, port, topo_name, cfg_name, fused):
    """``DeviceTransport(verify=False, axis=...)`` is accepted, keeps both,
    and its run is the verified run's: the same state bit for bit, the same
    executed bytes phase by phase, which are the reference's unverified
    run's."""
    name = f"{topo_name}/{cfg_name}/{fused}"
    b = _bundle(TASK, reference["x0"], reference["y0"])
    tr = DeviceTransport(fused=fused, verify=False, axis="ranks")
    assert tr.verify is False and tr.axis == "ranks" and DeviceTransport().verify is True
    st, mets = run_c2dfb_transport(b.problem, ptopo.make_topology(topo_name, M), C2DFBConfig(**CFGS[cfg_name]),
                                   b.x0, b.y0, T, None, tr, device="cpu", return_payloads=True)
    vst, vmets, _, _ = port[name]
    for a, v in zip(_tensors(st), _tensors(vst)):
        assert torch.equal(a, v)
    got = [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in mets["payloads"]]
    assert got == [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in vmets["payloads"]]
    want = reference["unverified"][name]
    assert got == want["phase_node_bytes"]
    assert [int(v) for v in mets["wire_bytes"]] == want["wire_bytes"] == [int(v) for v in vmets["wire_bytes"]]
    np.testing.assert_allclose(to_numpy(st.x), np.asarray(want["x"]), rtol=RTOL, atol=ATOL)


def test_fused_run_past_kpad_equals_the_reference(reference, monkeypatch):
    """The fused exchange drops a block's survivors past kpad as the
    reference's does: this run packs blocks of more than kpad survivors
    (counted here, at the pack), and every node's executed bytes,
    ``wire_bytes`` and ``measured_bytes`` equal the reference's, its state
    within rtol 1e-4 / atol 1e-6."""
    from repro_torch.transport import device as pdevice

    most, pack = [], pdevice._pack_tree

    def counting_pack(tree, block, kpad):
        for leaf in ptypes.tree_leaves(tree):
            flat = leaf.reshape(leaf.shape[0], -1)
            tiles = torch.nn.functional.pad(flat, (0, -flat.shape[1] % block)).reshape(-1, block)
            most.append(int(torch.count_nonzero(tiles, dim=1).max()))
        return pack(tree, block, kpad)

    monkeypatch.setattr(pdevice, "_pack_tree", counting_pack)
    want = reference["tie"]
    b = ptasks.coefficient_tuning_task(**TIE["task"], device="cpu")
    b = dataclasses.replace(b, x0=from_numpy(np.asarray(want["x0"], np.float32)), y0=torch.zeros_like(b.y0))
    sink = MemorySink()
    st, mets = run_c2dfb_transport(b.problem, ptopo.make_topology("ring", M), C2DFBConfig(**TIE["cfg"]), b.x0, b.y0,
                                   TIE["T"], None, DeviceTransport(fused=True), device="cpu", obs=sink,
                                   return_payloads=True)
    assert max(most) > 128, most
    assert [int(v) for v in mets["wire_bytes"]] == want["wire_bytes"]
    assert [int(v) for v in mets["measured_bytes"]] == want["measured_bytes"]
    assert [r["node_bytes"] for r in sink.rows(kind="node")] == want["node_bytes"]
    assert [{k: list(v) for k, v in pl["node_bytes"].items()} for pl in mets["payloads"]] == want["phase_node_bytes"]
    got = dict(x=st.x, s_x=st.s_x, y=st.inner_y.d, y_hat=st.inner_y.d_hat, z=st.inner_z.d, z_s_hat=st.inner_z.s_hat)
    for f, v in got.items():
        np.testing.assert_allclose(to_numpy(v), np.asarray(want["state"][f]), rtol=RTOL, atol=ATOL, err_msg=f)


# the fused round against run()'s round on run()'s own states: a wider task
# than TASK, so that each leaf spans several blocks
C4_TASK = dict(m=M, n=200, p=96, c=8, h=0.8, seed=0)
STATE_FIELDS = ("x", "s_x", "u", "y", "y_hat", "y_s", "y_s_hat", "y_g", "z", "z_hat", "z_s", "z_s_hat", "z_g")
# against the reference: the fields the runs above compare (a tracker sums
# gradients of order 1 into entries of order 1e-3, where the packages'
# rounding of the gradients alone reaches atol)
REF_FIELDS = ("x", "s_x", "y", "y_hat", "z", "z_s_hat")
C4_CFGS = {
    "kernel_topk": dict(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128, gamma_in=0.3, eta_in=0.3),
    "block_topk": dict(K=3, compressor="block_topk", comp_ratio=0.2, comp_block=128, gamma_in=0.3, eta_in=0.3),
}


@pytest.mark.parametrize("comp", sorted(C4_CFGS))
@pytest.mark.parametrize("topo_name", ["ring", "star"])
def test_fused_round_on_run_states_parts_only_at_near_ties(topo_name, comp, monkeypatch):
    """Round by round on the reference's sync states (stepped live, in
    process): the port's ``c2dfb_round`` on the round-t state records its
    top-k selections; the fused device round on the same state keeps them,
    every row where its own choice differs being a near-tie; both rounds
    agree within rtol 1e-4 / atol 1e-6 in every field, and with the
    reference's round t + 1 in the fields the runs above compare; and the
    fused round equals, in value, c2dfb_round with the exchange's mixing
    form (`mix_delta_shard`: the shifts or the gathered table) in place of
    the dense (W - I) @ hat."""
    jb = jtasks.coefficient_tuning_task(**C4_TASK)
    pb = ptasks.coefficient_tuning_task(**C4_TASK, device="cpu")
    cfg_kw = C4_CFGS[comp]
    jcfg, cfg = J.C2DFBConfig(**cfg_kw), C2DFBConfig(**cfg_kw)
    jtopo_, topo = jtopo.make_topology(topo_name, M), ptopo.make_topology(topo_name, M)
    jstep = jax.jit(lambda s, k: J.c2dfb_round(s, k, jb.problem, jtopo_, jcfg))
    jstates = [J.init_state(jb.problem, jcfg, jb.x0, jb.y0)]
    for t in range(T):
        jstates.append(jstep(jstates[-1], jax.random.PRNGKey(t))[0])
    round_fn = make_device_round(pb.problem, topo, cfg, mesh_for_nodes(M, "cpu"), fused=True)
    seen = selection.Partings()
    for t in range(T):
        state = from_numpy(jstates[t])
        log = []
        with selection.recorded(log):
            want, _ = c2dfb_round(state, None, pb.problem, topo, cfg)
        assert len(log) == 4 * cfg.K
        with selection.imposed(log, seen):
            x, s_x, u, iy, iz, _ = round_fn(state.x, state.s_x, state.u_prev, state.inner_y, state.inner_z, None)
        got = [x, s_x, u, *iy, *iz]
        # the exchange computes c2dfb_round with its own mixing form exactly
        with selection.imposed(log), monkeypatch.context() as mp:
            for mod in (pc2dfb, pinner):
                mp.setattr(mod, "mix_delta_dense", lambda W, v: mix_delta_shard(topo, v))
            ex, _ = c2dfb_round(state, None, pb.problem, topo, cfg)
        for a, b in zip(got, [ex.x, ex.s_x, ex.u_prev, *ex.inner_y, *ex.inner_z]):
            assert torch.equal(a, b), f"round {t}: the fused round differs from its mixing form's round"
        for name, a, w in zip(STATE_FIELDS, got, [want.x, want.s_x, want.u_prev, *want.inner_y, *want.inner_z]):
            np.testing.assert_allclose(to_numpy(a), to_numpy(w), rtol=RTOL, atol=ATOL, err_msg=f"round {t} {name}")
        ref = jstates[t + 1]
        for name, a, r in ((n, a, r) for n, a, r in zip(STATE_FIELDS, got, [
                ref.x, ref.s_x, ref.u_prev, *ref.inner_y, *ref.inner_z]) if n in REF_FIELDS):
            np.testing.assert_allclose(to_numpy(a), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=f"round {t} {name}")
    assert seen.compressions == T * 4 * cfg.K and seen.of_allowance <= 1.0
