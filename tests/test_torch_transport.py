"""The port's transports against a LIVE run of the JAX reference, in process.

* protocol conformance of both backends and their usage errors;
* `run(transport=SimTransport(f))` is `run(fabric=f)` bit for bit: sync,
  async eager and async compiled;
* `inner_loop` / `c2dfb_round` / `mdbo_round` / `madsbo_round` price
  through a transport exactly as through its fabric, and as the reference;
* the rank-level gossip engines and `make_sharded_inner_loop` against the
  reference's dense and sharded semantics;
* `_pack_tree` / `_unpack_like` exact, their records the reference's; a
  block of more than kpad survivors keeps its first kpad in lane order in
  both packages (f32 and bf16);
* `DeviceTransport` on ring (neighbour shifts) and star (all-gather),
  dense and fused: the trajectory within rtol 1e-4 / atol 1e-6 of the
  reference's sequential run, ``measured_bytes`` equal, every executed
  node byte the reference's `measure_tree_bytes(_chunked)` of the same
  arrays, fused bit-identical to dense, and the obs round and node rows
  of the reference's contract (tests/test_transport.py:317-349).

The reference's own DeviceTransport needs 8 forced host devices, so its
live run sits in tests/test_torch_device_transport.py (a subprocess)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import c2dfb as J
from repro.core import topology as jtopo
from repro.data import bilevel_tasks as jtasks
from repro.net import make_fabric as jmake_fabric
from repro.net import wire as jwire
from repro_torch.core import compression as PC
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.c2dfb import C2DFBConfig, c2dfb_round, init_state, run
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.kernels import _build
from repro_torch.net import BConnectedSchedule, make_fabric
from repro_torch.net import wire as pwire
from repro_torch.obs import MemorySink
from repro_torch.transport import (
    DeviceTransport,
    ExchangeReport,
    SimTransport,
    Transport,
    mesh_for_nodes,
    run_c2dfb_transport,
)
from repro_torch.transport.device import _pack_tree, _unpack_like, fused_pack_spec

from _torch_replay import JaxReplay, record_quant_margins, run_leaf_keys

RTOL, ATOL = 1e-4, 1e-6
KEY = jax.random.PRNGKey(0)
M, T = 4, 3
TASK = dict(m=M, n=80, p=12, c=3, h=0.5, seed=0)
# tests/test_transport.py's configuration; the block-sparse one has 36
# values a node in one block of 128 (k = 38 > 36: the block form holds
# every residual entry, so the fused exchange is exercised at full load)
CFG = dict(K=3, compressor="topk", comp_ratio=0.3, gamma_in=0.3, eta_in=0.3)
CFG_BLOCK = dict(CFG, compressor="block_topk", comp_block=128)


def _bundles(**kw):
    """The reference's task and the port's, the port's x0 / y0 taken from
    the reference (its draws are jax's)."""
    jb, pb = jtasks.coefficient_tuning_task(**kw), ptasks.coefficient_tuning_task(**kw, device="cpu")
    return jb, dataclasses.replace(pb, x0=from_numpy(jb.x0), y0=from_numpy(jb.y0))


@pytest.fixture(scope="module")
def bundles():
    return _bundles(**TASK)


def _close(got, want, what):
    g, w = ptypes.tree_leaves(to_numpy(got)), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


def _states_close(ps, js):
    for f in ("x", "s_x", "u_prev"):
        _close(getattr(ps, f), getattr(js, f), f)
    for f in ("inner_y", "inner_z"):
        for g in ("d", "d_hat", "s", "s_hat", "g_prev"):
            _close(getattr(getattr(ps, f), g), getattr(getattr(js, f), g), f"{f}.{g}")
    assert ps.t == int(js.t)


def _states_equal(a, b):
    for f in ("x", "s_x", "u_prev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("inner_y", "inner_z"):
        for g, u, v in zip(a.inner_y._fields, getattr(a, f), getattr(b, f)):
            assert torch.equal(u, v), f"{f}.{g}"


def _metrics_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        u, v = a[k], b[k]
        u = u.cpu().numpy() if torch.is_tensor(u) else np.asarray(u)
        v = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        np.testing.assert_array_equal(u, v, err_msg=k)


# ---------------------------------------------------------------------------
# protocol conformance and usage errors
# ---------------------------------------------------------------------------


def test_transport_is_abstract():
    with pytest.raises(TypeError):
        Transport()  # bind / executes / exchange are abstract


def test_sim_transport_mirrors_fabric_pricing_and_the_reference():
    topo, jt = ptopo.ring(M), jtopo.ring(M)
    fabric = make_fabric(topo, profile="wan", seed=7, compute_s=0.01)
    t = SimTransport(make_fabric(topo, profile="wan", seed=7, compute_s=0.01)).bind(topo)
    jfab = jmake_fabric(jt, profile="wan", seed=7, compute_s=0.01)
    assert t.topo is t.fabric.topo
    assert t.egress_s(1000) == fabric.egress_s(1000) == jfab.egress_s(1000)
    assert fabric.message_arrival(1.0, 500, fabric.round_rng(3)) == t.message_arrival(1.0, 500, t.round_rng(3))
    rep_f = fabric.simulate_round([1000, 2000], 5, labels=["a", "b"])
    rep_t = t.simulate_round([1000, 2000], 5, labels=["a", "b"])
    rep_j = jfab.simulate_round([1000, 2000], 5, labels=["a", "b"])
    assert rep_f["sim_seconds"] == rep_t["sim_seconds"] == rep_j["sim_seconds"]
    assert rep_f["wire_bytes"] == rep_t["wire_bytes"] == rep_j["wire_bytes"]
    assert fabric.clock_s == t.clock_s
    t.reset()
    assert t.clock_s == 0.0


def _compressed_payload(bundles, comp_name="topk"):
    jb, _ = bundles
    jcomp = J.C2DFBConfig(**dict(CFG, compressor=comp_name)).make_compressor()
    jpay = jcomp.compress_tree(jax.random.PRNGKey(1), jax.tree.map(lambda v: v * 0.1, jb.y0))
    return jcomp, jpay, from_numpy(jpay)


@pytest.mark.parametrize("backend", ["sim", "device"])
def test_exchange_delivers_with_codec_bytes(bundles, backend):
    """Both exchange faces: the sim delivers by identity, the device backend
    the codec's receipt (exact here); node bytes are the reference's
    `measure_tree_bytes` of each slice, wire bytes their degree sum."""
    topo = ptopo.ring(M)
    jcomp, jpay, pay = _compressed_payload(bundles)
    comp = C2DFBConfig(**CFG).make_compressor()
    if backend == "sim":
        t = SimTransport(make_fabric(topo, profile="lan", seed=0)).bind(topo)
    else:
        t = DeviceTransport().bind(topo, device="cpu")
    delivered, rep = t.exchange(pay, comp, round_idx=0)
    assert torch.equal(delivered, pay)
    assert isinstance(rep, ExchangeReport)
    for i in range(M):
        assert rep.node_bytes[i] == jwire.measure_tree_bytes(jcomp, jpay[i][None])
    deg = [len(topo.neighbors[i]) for i in range(M)]
    assert rep.wire_bytes == sum(d * b for d, b in zip(deg, rep.node_bytes))
    assert rep.duration_s > 0.0 if backend == "sim" else rep.wall_s > 0.0


def test_transport_usage_errors(bundles):
    from repro_torch.async_gossip.scheduler import AsyncScheduler

    _, pb = bundles
    topo = ptopo.ring(M)
    cfg = C2DFBConfig(**CFG)
    with pytest.raises(ValueError, match="not bound"):
        SimTransport().simulate_round([100], 0)
    with pytest.raises(ValueError, match="fabric OR transport"):
        run(pb.problem, topo, cfg, pb.x0, pb.y0, T=1, device="cpu",
            fabric=make_fabric(topo), transport=SimTransport())
    with pytest.raises(ValueError, match="fabric OR transport"):
        c2dfb_round(init_state(pb.problem, cfg, pb.x0, pb.y0), None, pb.problem, topo, cfg,
                    fabric=make_fabric(topo), transport=SimTransport())
    with pytest.raises(ValueError, match="fabric OR profile kwargs"):
        SimTransport(make_fabric(topo), profile="wan")
    with pytest.raises(ValueError, match="bound to topology"):
        SimTransport(make_fabric(topo)).bind(topo).bind(ptopo.star(6))
    with pytest.raises(ValueError, match="not bound"):
        AsyncScheduler(SimTransport())
    with pytest.raises(ValueError, match="chunk"):
        DeviceTransport(chunk=0)
    assert DeviceTransport(fused=True).chunk == 1 << 16  # fused implies chunked metering
    with pytest.raises(ValueError, match="mesh has 3 ranks but the topology has 4 nodes"):
        DeviceTransport(mesh=mesh_for_nodes(3, "cpu")).bind(topo)
    with pytest.raises(ValueError, match="bound to 'ring'"):
        DeviceTransport().bind(topo, device="cpu").bind(ptopo.star(M))
    with pytest.raises(ValueError, match="block-sparse"):
        fused_pack_spec(PC.TopK(ratio=0.3))
    assert fused_pack_spec(PC.KernelBlockTopK(ratio=0.2, block=1024)) == (1024, 256)
    # a fused run refuses a compressor whose residuals are not block tiles
    with pytest.raises(ValueError, match="block-sparse"):
        run(pb.problem, topo, cfg, pb.x0, pb.y0, T=1, device="cpu", transport=DeviceTransport(fused=True))


class _ExecutingStub(Transport):
    """Minimal executing transport: enough to reach the engine's
    unsupported-feature checks without a mesh."""

    @property
    def executes(self) -> bool:
        return True

    def bind(self, topo):
        return self

    def exchange(self, payload, compressor, round_idx):  # pragma: no cover
        raise AssertionError("feature checks must fire before exchange")


@pytest.mark.parametrize("feature,kw", [
    ("async_mode", dict(async_mode="bounded")),
    ("version_rule", dict(version_rule="acked")),
    ("compiled", dict(compiled=True)),
    ("schedule", None),  # built in the test body (needs the topology)
])
@pytest.mark.parametrize("transport", ["stub", "device"])
def test_device_unsupported_features_raise_named_notimplemented(bundles, feature, kw, transport):
    """Every feature an executing transport cannot run raises
    NotImplementedError naming it; mixing_damping raises a ValueError."""
    _, pb = bundles
    topo = ptopo.ring(M)
    if kw is None:
        kw = dict(schedule=BConnectedSchedule(topo, B=2))
    tr = _ExecutingStub() if transport == "stub" else DeviceTransport()
    with pytest.raises(NotImplementedError, match=f"does not support {feature}"):
        run_c2dfb_transport(pb.problem, topo, C2DFBConfig(**CFG), pb.x0, pb.y0, 2, None, tr, device="cpu", **kw)
    with pytest.raises(ValueError, match="mixing_damping"):
        run_c2dfb_transport(
            pb.problem, topo, C2DFBConfig(**CFG), pb.x0, pb.y0, 2, None, tr, device="cpu", mixing_damping="inverse-age"
        )


# ---------------------------------------------------------------------------
# SimTransport: bit for bit the fabric path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sync", "async", "compiled"])
def test_sim_transport_run_bit_exact(bundles, mode):
    _, pb = bundles
    topo, cfg = ptopo.ring(M), C2DFBConfig(**CFG)
    fab = dict(profile="wan", seed=0)
    kw = {}
    if mode != "sync":
        fab = dict(profile="geo", straggler="lognormal", compute_s=0.01, seed=0)
        kw = dict(async_mode="bounded", staleness_bound=1, compiled=mode == "compiled")
    s1, m1 = run(pb.problem, topo, cfg, pb.x0, pb.y0, T=T, device="cpu", fabric=make_fabric(topo, **fab), **kw)
    s2, m2 = run(pb.problem, topo, cfg, pb.x0, pb.y0, T=T, device="cpu",
                 transport=SimTransport(make_fabric(topo, **fab)), **kw)
    m1.pop("ledger", None), m2.pop("ledger", None)
    _metrics_equal(m1, m2)
    _states_equal(s1, s2)


def test_inner_loop_and_round_pricing_through_a_transport(bundles):
    """The pricing face gives the fabric's and the reference's figures:
    `inner_loop`, `c2dfb_round`, `mdbo_round` and `madsbo_round`."""
    from repro.core import baselines as JB
    from repro.core import inner_loop as JI
    from repro.transport import SimTransport as JSim
    from repro_torch.core import baselines as PB
    from repro_torch.core.inner_loop import inner_init, inner_loop

    jb, pb = bundles
    topo, jt = ptopo.ring(M), jtopo.ring(M)
    comp, jcomp = C2DFBConfig(**CFG).make_compressor(), J.C2DFBConfig(**CFG).make_compressor()
    W = torch.as_tensor(topo.W, dtype=torch.float32)
    st0 = inner_init(pb.y0, lambda d: d * 0.1)
    _, mf = inner_loop(st0, None, lambda d: d * 0.1, W, comp, 0.3, 0.1, 3, fabric=make_fabric(topo, profile="wan", seed=0))
    _, mt = inner_loop(st0, None, lambda d: d * 0.1, W, comp, 0.3, 0.1, 3,
                       transport=SimTransport(make_fabric(topo, profile="wan", seed=0)).bind(topo))
    jst = JI.inner_init(jb.y0, lambda d: d * 0.1)
    _, mj = JI.inner_loop(jst, KEY, lambda d: d * 0.1, jnp.asarray(jt.W, jnp.float32), jcomp, 0.3, 0.1, 3,
                          transport=JSim(jmake_fabric(jt, profile="wan", seed=0)).bind(jt))
    assert mf["wire_bytes"] == mt["wire_bytes"] == mj["wire_bytes"]
    assert mf["sim_seconds"] == mt["sim_seconds"] == mj["sim_seconds"]

    cfg = C2DFBConfig(**CFG)
    st = init_state(pb.problem, cfg, pb.x0, pb.y0)
    _, cf = c2dfb_round(st, None, pb.problem, topo, cfg, fabric=make_fabric(topo, profile="wan", seed=0))
    _, ct = c2dfb_round(st, None, pb.problem, topo, cfg, transport=SimTransport(make_fabric(topo, profile="wan", seed=0)))
    assert cf["wire_bytes"] == ct["wire_bytes"] and cf["sim_seconds"] == ct["sim_seconds"]

    for alg in ("mdbo", "madsbo"):
        pcfg = PB.MDBOConfig(K=2, neumann_N=2) if alg == "mdbo" else PB.MADSBOConfig(K=2, Q=2)
        jcfg = JB.MDBOConfig(K=2, neumann_N=2) if alg == "mdbo" else JB.MADSBOConfig(K=2, Q=2)
        if alg == "mdbo":
            pst, jst_ = PB.mdbo_init(pb.x0, pb.y0), JB.mdbo_init(jb.x0, jb.y0)
        else:
            pst, jst_ = PB.madsbo_init(pb.problem, pb.x0, pb.y0), JB.madsbo_init(jb.problem, jb.x0, jb.y0)
        fn, jfn = getattr(PB, f"{alg}_round"), getattr(JB, f"{alg}_round")
        _, bf = fn(pst, pb.problem, topo, pcfg, fabric=make_fabric(topo, profile="wan", seed=0))
        _, bt = fn(pst, pb.problem, topo, pcfg, transport=SimTransport(make_fabric(topo, profile="wan", seed=0)))
        _, bj = jfn(jst_, jb.problem, jt, jcfg, transport=JSim(jmake_fabric(jt, profile="wan", seed=0)))
        assert bf["wire_bytes"] == bt["wire_bytes"] == bj["wire_bytes"], alg
        assert bf["sim_seconds"] == bt["sim_seconds"] == bj["sim_seconds"], alg
        with pytest.raises(ValueError, match="fabric OR transport"):
            fn(pst, pb.problem, topo, pcfg, fabric=make_fabric(topo), transport=SimTransport())


# ---------------------------------------------------------------------------
# rank-level gossip engines and the sharded inner loop
# ---------------------------------------------------------------------------


def _ppermute_reference(t, x):
    """tests/test_gossip.py's numpy semantics of the shift schedule."""
    acc = np.zeros_like(x)
    for shift, w in t.ppermute_schedule:
        acc += w * (np.roll(x, shift, axis=0) - x)
    return acc


@pytest.mark.parametrize("name", ["ring", "two_hop", "torus", "er", "star"])
def test_shard_gossip_matches_dense_and_the_reference(name):
    from repro.core.gossip import mix_delta_dense as jmix
    from repro.core.gossip import mix_step_dense as jstep
    from repro_torch.core.gossip import mix_delta_allgather, mix_delta_ppermute, mix_step_shard

    m = 16 if name == "torus" else 8
    pt = ptopo.torus2d(4, 4) if name == "torus" else ptopo.make_topology(name, m)
    jt = jtopo.torus2d(4, 4) if name == "torus" else jtopo.make_topology(name, m)
    x = np.random.default_rng(2).normal(size=(m, 17)).astype(np.float32)
    Wj = jnp.asarray(jt.W, jnp.float32)
    want = np.asarray(jmix(Wj, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    if pt.ppermute_schedule is not None:
        got = mix_delta_ppermute(pt, xt).numpy()
        np.testing.assert_allclose(got, _ppermute_reference(jt, x), rtol=1e-6, atol=1e-6)
    else:
        with pytest.raises(ValueError, match="no static ppermute schedule"):
            mix_delta_ppermute(pt, xt)
    np.testing.assert_allclose(got if pt.ppermute_schedule is not None else want, want, atol=1e-5)
    # the gather works on every graph: each rank's row of W - I on the table
    rows = np.stack([(jt.W[i] - np.eye(m)[i]) @ x for i in range(m)])
    np.testing.assert_allclose(mix_delta_allgather(pt, xt).numpy(), rows, atol=1e-5)
    np.testing.assert_allclose(mix_step_shard(pt, 0.7, xt).numpy(), np.asarray(jstep(Wj, 0.7, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("name", ["ring", "star"])
def test_rank_engines_mix_bf16_leaves_in_f32(name):
    """One dtype rule for every rank-level engine: the mixing arithmetic in
    f32, emitted at the leaf's dtype (the reference's device-transport
    gossiper's rule, ROADMAP §C); the device gossipers mix by the same
    functions as `mix_delta_shard`."""
    from repro_torch.core.gossip import mix_delta_shard
    from repro_torch.transport.device import _gossiper

    m = 8
    pt = ptopo.make_topology(name, m)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(m, 33)).astype(np.float32)).to(torch.bfloat16)
    got = mix_delta_shard(pt, x)
    assert got.dtype == torch.bfloat16
    xf = x.to(torch.float32)
    if pt.ppermute_schedule is not None:
        want = torch.zeros_like(xf)
        for shift, w in pt.ppermute_schedule:
            want = want + w * (torch.roll(xf, shift, 0) - xf)
        assert torch.equal(got, want.to(torch.bfloat16))
    else:
        want = (torch.as_tensor(pt.W, dtype=torch.float32) - torch.eye(m)) @ xf
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=1e-2, atol=1e-2)
    g = _gossiper(pt, "cpu")
    assert torch.equal(g.mix(g.init(x), x), got)


def test_sharded_inner_loop_matches_the_simulators():
    """tests/test_distributed.py's parity: identity exact (< 1e-5) against
    the reference's node-stacked loop, consensus after 400 steps, top-k
    agreeing in the node mean; and rank-local stochastic draws."""
    from repro.core import compression as JC
    from repro.core.inner_loop import inner_init as j_init
    from repro.core.inner_loop import inner_loop as j_loop
    from repro.core.types import node_mean as j_mean
    from repro_torch.core.distributed import make_sharded_inner_loop
    from repro_torch.core.inner_loop import InnerState, inner_init, inner_loop

    m, d = 8, 32
    rng = np.random.default_rng(0)
    A = np.stack([np.eye(d) * (1 + 0.2 * i) for i in range(m)]).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    jA, jbv = jnp.asarray(A), jnp.asarray(b)
    j_grad = lambda w: jnp.einsum("mij,mj->mi", jA, w - jbv)  # noqa: E731
    data = {"A": torch.from_numpy(A), "b": torch.from_numpy(b)}
    grad_local = lambda w, dat: dat["A"] @ (w - dat["b"])  # noqa: E731
    p_grad = lambda w: torch.einsum("mij,mj->mi", data["A"], w - data["b"])  # noqa: E731
    d0 = np.array(jax.random.normal(KEY, (m, d)))
    jt, pt = jtopo.ring(m), ptopo.ring(m)
    Wj = jnp.asarray(jt.W, jnp.float32)
    mesh = mesh_for_nodes(m, "cpu")
    gamma, eta, K = 0.4, 0.1, 25
    td0 = torch.from_numpy(d0)
    g0 = p_grad(td0)
    st0 = InnerState(d=td0, d_hat=td0, s=g0, s_hat=g0, g_prev=g0)

    ref, _ = j_loop(j_init(jnp.asarray(d0), j_grad), KEY, j_grad, Wj, JC.Identity(), gamma, eta, K)
    out = make_sharded_inner_loop(mesh, pt, grad_local, PC.Identity(), gamma, eta, K)(st0, None, data)
    assert float(np.max(np.abs(out.d.numpy() - np.asarray(ref.d)))) < 1e-5
    sim, _ = inner_loop(inner_init(td0, p_grad), None, p_grad, torch.as_tensor(pt.W, dtype=torch.float32),
                        PC.Identity(), gamma, eta, K)
    assert float((out.d - sim.d).abs().max()) < 1e-5
    long = make_sharded_inner_loop(mesh, pt, grad_local, PC.Identity(), gamma, eta, 400)(st0, None, data)
    assert float(((long.d - long.d.mean(0)) ** 2).sum()) < 1e-2

    ref2, _ = j_loop(j_init(jnp.asarray(d0), j_grad), KEY, j_grad, Wj, JC.TopK(ratio=0.5), gamma, eta, K)
    out2 = make_sharded_inner_loop(mesh, pt, grad_local, PC.TopK(ratio=0.5), gamma, eta, K)(st0, None, data)
    assert float(np.max(np.abs(out2.d.mean(0).numpy() - np.asarray(j_mean(ref2.d))))) < 0.05

    # rank-local draws: one draw a rank and leaf, m a message
    class Counting(PC.TorchSource):
        n = 0

        def uniform(self, shape, device, dtype=torch.float32):
            Counting.n += 1
            assert tuple(shape) == (1, 128)  # one rank's tile
            return super().uniform(shape, device, dtype)

    loop = make_sharded_inner_loop(mesh, pt, grad_local, PC.KernelQuant(bits=4, block=128), gamma, eta, 2)
    out3 = loop(st0, Counting(torch.Generator().manual_seed(0)), data)
    assert Counting.n == 2 * 2 * m and bool(torch.isfinite(out3.d).all())
    with pytest.raises(ValueError, match="mesh has 4 ranks"):
        make_sharded_inner_loop(mesh_for_nodes(4, "cpu"), pt, grad_local, PC.Identity(), gamma, eta, 1)


# ---------------------------------------------------------------------------
# the fused pack / unpack pair
# ---------------------------------------------------------------------------


def _residual_tree(dtype=np.float32):
    """A node-stacked residual tree whose leaves are smaller and larger than
    a block, so the padding of every rank's last block is exercised."""
    rng = np.random.default_rng(3)
    return {k: rng.normal(size=(M, *s)).astype(np.float32) for k, s in
            (("w", (24, 40)), ("b", (50,)), ("g", (7,)))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unpack_exact_and_the_reference_records(dtype):
    from repro.core import compression as JC
    from repro.transport.device import _pack_tree as j_pack

    jcomp = JC.BlockTopK(ratio=0.25, block=128)
    jdt = getattr(jnp, dtype)
    tree = {k: jnp.asarray(v, jdt) for k, v in _residual_tree().items()}
    jq = jax.tree.map(lambda v: jax.vmap(lambda r: jcomp(KEY, r))(v), tree)
    q = from_numpy(jq)
    comp = PC.BlockTopK(ratio=0.25, block=128)
    block, kpad = fused_pack_spec(comp)
    assert (block, kpad) == (128, 128)  # 32 survivors padded to the lane boundary
    _build.reset_launch_counts()
    vals, idx = _pack_tree(q, block, kpad)
    back = _unpack_like(vals, idx, q, block)
    for a, b in zip(ptypes.tree_leaves(back), ptypes.tree_leaves(q)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    for r in range(M):  # every rank's records are the reference's pack of its slice
        jv, ji = j_pack(jax.tree.map(lambda v: v[r][None], jq), block, kpad)
        for pv, jvl in zip(ptypes.tree_leaves(vals), jax.tree.leaves(jv)):
            np.testing.assert_array_equal(pv[r].numpy(), np.asarray(jvl)[0])
        for pi, jil in zip(ptypes.tree_leaves(idx), jax.tree.leaves(ji)):
            np.testing.assert_array_equal(pi[r].numpy(), np.asarray(jil)[0])
    assert sum(_build.launch_counts().values()) == 0  # CPU tensors: the plain versions


@pytest.mark.parametrize("name", ["ring", "star"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_push_and_apply_equal_the_dense_exchange(name, dtype):
    """The fused exchange unpacks the records straight onto each copy (or
    the table) and the sender's own reference in one pass: bit for bit the
    dense push of the residual, and, on a base holding -0.0, bit for bit
    the reference's order (unpack, cast, then add: the empty lane's +0.0
    turns a -0.0 base into +0.0)."""
    from repro_torch.core.types import tree_map
    from repro_torch.transport.device import _gossiper, _unpack_onto

    pt = ptopo.make_topology(name, M)
    g = _gossiper(pt, "cpu")
    rng = np.random.default_rng(4)
    hat = {k: torch.from_numpy(v).to(dtype) for k, v in _residual_tree().items()}
    comp = PC.KernelBlockTopK(ratio=0.25, block=128)
    q = {k: comp.compress_nodes(torch.from_numpy(rng.normal(size=v.shape).astype(np.float32)).to(dtype))
         for k, v in hat.items()}
    block, kpad = fused_pack_spec(comp)
    packed = _pack_tree(q, block, kpad)
    copies = g.init(hat)
    _build.reset_launch_counts()

    def leaves(copies):  # the ring keeps a tree a shift, the gather one table
        return [v for t in (copies if isinstance(copies, tuple) else (copies,)) for v in ptypes.tree_leaves(t)]

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    for a, b in zip(leaves(g.push_packed(copies, packed, block)), leaves(g.push(copies, q)), strict=True):
        assert a.dtype == dtype and torch.equal(bits(a), bits(b))
    applied = _unpack_onto(*packed, hat, block)
    for a, b in zip(leaves(applied), leaves(tree_map(torch.add, hat, q)), strict=True):
        assert torch.equal(bits(a), bits(b))
    # a -0.0 base: +0.0 on the empty lanes, as the reference's order gives
    neg = tree_map(lambda v: torch.full_like(v, -0.0), hat)
    got = _unpack_onto(*packed, neg, block)
    want = tree_map(torch.add, neg, _unpack_like(*packed, neg, block))
    for a, b, r in zip(leaves(got), leaves(want), leaves(q), strict=True):
        assert torch.equal(bits(a), bits(b)) and not torch.signbit(a[r == 0]).any()
    assert _build.launch_counts()["unpack_sparse_blocks"] == 0  # CPU tensors: the plain versions


def _reference_pack(q: np.ndarray, block: int, kpad: int):
    """The reference's `_pack_tree` rank by rank (its leaves are one rank's,
    (1, *shape)), stacked over the ranks."""
    from repro.transport.device import _pack_tree as jpack

    packs = [jpack({"w": jnp.asarray(q[r:r + 1])}, block, kpad) for r in range(q.shape[0])]
    return (np.concatenate([np.asarray(v["w"]) for v, _ in packs]),
            np.concatenate([np.asarray(i["w"]) for _, i in packs]))


def _over_full_residuals(dtype):
    """Residuals whose blocks hold more than kpad = 128 survivors: a
    384-way tie that block top-k keeps whole (256 survivors in block 0),
    and a rank of a few large values among many small ones."""
    tie = PC.KernelBlockTopK(ratio=0.5, block=256).compress_nodes(torch.ones((1, 384), dtype=dtype))
    rng = np.random.default_rng(0)
    mixed = torch.from_numpy(np.where(rng.random(512) < 0.7, 1e-3, 1.0) * rng.choice([-1.0, 1.0], 512))
    mixed = PC.KernelBlockTopK(ratio=0.5, block=256).compress_nodes(mixed.to(dtype)[None])
    return torch.cat([tie, mixed[:, :384]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pack_tree_drops_past_kpad_as_the_reference(dtype):
    """A block of more than kpad survivors keeps its first kpad in lane
    order, in both packages: equal records, and the unpacked residual is
    the kept survivors."""
    q = _over_full_residuals(dtype)
    blocks = torch.nn.functional.pad(q, (0, 128)).reshape(2, 2, 256)  # (rank, block, lane)
    counts = torch.count_nonzero(blocks, dim=2)
    assert int(counts[0, 0]) == 256 and int(counts[1].max()) > 128
    vals, idx = _pack_tree({"w": q}, 256, 128)
    jv, ji = _reference_pack(q.to(torch.float32).numpy(), 256, 128)
    np.testing.assert_array_equal(vals["w"].reshape(jv.shape).numpy(), jv)
    np.testing.assert_array_equal(idx["w"].reshape(ji.shape).numpy(), ji)
    got = _unpack_like(vals, idx, {"w": q}, 256)["w"]
    assert got.dtype == dtype
    rank = torch.cumsum((blocks != 0).to(torch.int64), dim=2) - 1
    kept = torch.where(rank < 128, blocks, torch.zeros((), dtype=dtype)).reshape(2, -1)[:, :384]
    assert torch.equal(got, kept)


def test_pack_tree_keeps_every_survivor_up_to_kpad():
    q = torch.zeros((2, 256))
    q[1, 128:] = 1.0  # rank 1's second block: exactly kpad = 128 survivors
    q[0, :129] = 2.0  # rank 0: 128 in its first block, 1 in its second
    vals, idx = _pack_tree({"w": q}, 128, 128)
    assert torch.equal(_unpack_like(vals, idx, {"w": q}, 128)["w"], q)
    jv, ji = _reference_pack(q.numpy(), 128, 128)
    np.testing.assert_array_equal(vals["w"].reshape(jv.shape).numpy(), jv)
    np.testing.assert_array_equal(idx["w"].reshape(ji.shape).numpy(), ji)


def test_packed_records_match_the_reference_chunked_encoding():
    from repro.core import compression as JC
    from repro.net import wire as jw

    jcomp = JC.BlockTopK(ratio=0.25, block=128)
    jq = {k: jax.vmap(lambda r: jcomp(KEY, r))(jnp.asarray(v)) for k, v in _residual_tree().items()}
    q = from_numpy(jq)
    vals, idx = _pack_tree(q, 128, 128)
    sizes = [int(np.prod(v.shape[1:])) for v in jax.tree.leaves(jq)]
    for r in range(M):
        vl = [v[r].numpy() for v in ptypes.tree_leaves(vals)]
        il = [i[r].numpy() for i in ptypes.tree_leaves(idx)]
        slc = [np.asarray(v)[r] for v in jax.tree.leaves(jq)]
        for chunk in (64, 1 << 10, 1 << 16):
            got = pwire.encode_packed_records_chunked(vl, il, sizes, 128, chunk)
            assert got == jw.codec_for(jcomp).encode_tree_chunked(slc, chunk)
            assert sum(len(p) for p in got) == jw.measure_tree_bytes_chunked(jcomp, slc, chunk)


# ---------------------------------------------------------------------------
# DeviceTransport against the reference's sequential run
# ---------------------------------------------------------------------------


def _device_run(pb, topo, cfg_kw, **kw):
    sink = MemorySink()
    _build.reset_launch_counts()
    state, mets = run_c2dfb_transport(
        pb.problem, topo, C2DFBConfig(**cfg_kw), pb.x0, pb.y0, T, None,
        DeviceTransport(**kw), device="cpu", return_payloads=True, obs=sink,
    )
    return state, mets, sink


@pytest.fixture(scope="module", params=["ring", "star"])
def device_runs(request, bundles):
    jb, pb = bundles
    jt, pt = jtopo.make_topology(request.param, M), ptopo.make_topology(request.param, M)
    out = {"name": request.param, "jt": jt, "pt": pt}
    for cfg_name, cfg_kw in (("topk", CFG), ("block", CFG_BLOCK)):
        out[cfg_name] = J.run(jb.problem, jt, J.C2DFBConfig(**cfg_kw), jb.x0, jb.y0, T=T, key=KEY)
    out["dense"] = _device_run(pb, pt, CFG)
    out["block_dense"] = _device_run(pb, pt, CFG_BLOCK)
    out["block_fused"] = _device_run(pb, pt, CFG_BLOCK, fused=True)
    return out


@pytest.mark.parametrize("which", ["dense", "block_dense", "block_fused"])
def test_device_transport_matches_the_reference_run(device_runs, which):
    state, mets, _ = device_runs[which]
    js, jm = device_runs["topk" if which == "dense" else "block"]
    _states_close(state, js)
    np.testing.assert_array_equal(mets["measured_bytes"], np.asarray(jm["measured_bytes"]))
    for k in ("hypergrad_norm", "x_consensus_err", "sx_consensus_err", "y_consensus_err", "z_consensus_err"):
        np.testing.assert_allclose(mets[k], np.asarray(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(mets["x_node_dist"], np.asarray(jm["x_node_dist"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["dense", "block_dense", "block_fused"])
def test_device_executed_bytes_are_the_reference_codec(device_runs, which):
    """Every executed inner message's node bytes equal the reference's
    `measure_tree_bytes` (chunked for the fused run) of the same arrays,
    and each round's wire bytes the degree-weighted sum of them."""
    _, mets, _ = device_runs[which]
    pt = device_runs["pt"]
    cfg = J.C2DFBConfig(**(CFG if which == "dense" else CFG_BLOCK))
    jcomp = cfg.make_compressor()
    deg = [len(pt.neighbors[i]) for i in range(M)]
    for t, pl in enumerate(mets["payloads"]):
        for tag in ("y", "z"):
            q_d, q_s = pl[tag]
            for k in range(cfg.K):
                for name, stack in (("d", q_d), ("s", q_s)):
                    nb = pl["node_bytes"][f"{tag}/in{k}/{name}"]
                    for i in range(M):
                        if which == "block_fused":
                            vals, idx = stack
                            dense = jwire.scatter_packed_records([vals[k, i]], [idx[k, i]], [36], 128)
                            want = jwire.measure_tree_bytes_chunked(jcomp, [dense], 1 << 16)
                        else:
                            want = jwire.measure_tree_bytes(jcomp, stack[k, i][None])
                        assert nb[i] == want, (t, tag, k, name, i)
        total = sum(d * b for nb in pl["node_bytes"].values() for d, b in zip(deg, nb))
        assert total == int(mets["wire_bytes"][t])


def test_device_fused_is_bit_identical_to_dense(device_runs):
    (sd, md, _), (sf, mf, _) = device_runs["block_dense"], device_runs["block_fused"]
    _states_equal(sd, sf)
    for k in ("hypergrad_norm", "x_consensus_err", "sx_consensus_err", "y_consensus_err", "y_compress_err",
              "z_consensus_err", "x_node_dist", "measured_bytes", "wire_bytes"):
        np.testing.assert_array_equal(md[k], mf[k], err_msg=k)
    for t in range(T):  # the packed records scatter to the dense payloads
        for tag in ("y", "z"):
            for (vals, idx), dense in zip(mf["payloads"][t][tag], md["payloads"][t][tag]):
                for k in range(3):
                    for i in range(M):
                        got = pwire.scatter_packed_records([vals[k, i]], [idx[k, i]], [36], 128)
                        np.testing.assert_array_equal(got, dense[k, i].reshape(-1))


@pytest.mark.parametrize("which", ["dense", "block_fused"])
def test_device_obs_rows_follow_the_reference_contract(device_runs, which):
    _, mets, sink = device_runs[which]
    pt = device_runs["pt"]
    deg = [len(pt.neighbors[i]) for i in range(M)]
    rows = sink.rows(kind="round")
    assert len(rows) == T
    for t, r in enumerate(rows):
        assert r["engine"] == "transport-device"
        assert set(r["bytes_by_stream"]) == {"outer", "y", "z"}
        assert sum(r["bytes_by_stream"].values()) == r["wire_bytes"] == int(mets["wire_bytes"][t])
        assert r["wall_seconds"] > 0.0
        assert r["oracle_calls"] == {"ul_grad": 3 * M, "ll_grad": 2 * 4 * M, "hvp": 0, "jvp": 0}
    nrows = sink.rows(kind="node")
    assert len(nrows) == T * M
    for t in range(T):
        rows_t = sorted((r for r in nrows if r["round"] == t), key=lambda r: r["node"])
        assert [r["node"] for r in rows_t] == list(range(M))
        for r in rows_t:
            assert r["engine"] == "transport-device"
            assert sum(r["bytes_by_stream"].values()) == r["node_bytes"]
            assert r["wire_bytes"] == deg[r["node"]] * r["node_bytes"]
            assert r["x_dist"] >= 0.0 and r["staleness_max"] == 0
        assert sum(r["wire_bytes"] for r in rows_t) == int(mets["wire_bytes"][t])


def test_device_transport_kernel_quant_on_the_reference_draws(bundles):
    """A stochastic compressor draws what the simulator draws: the device
    run on the reference's own draws (replayed) follows the reference's
    sequential run; the KernelQuant wire round trip verifies within its
    1-ulp allowance."""
    kw = dict(m=M, n=200, p=64, c=4, seed=0)
    cfg_kw = dict(K=3, compressor="kernel_quant", comp_bits=4, comp_block=128)
    key = jax.random.PRNGKey(17)  # tests/test_torch_c2dfb.py's key for this config
    jb, pb = _bundles(**kw)
    js, jm = J.run(jb.problem, jtopo.ring(M), J.C2DFBConfig(**cfg_kw), jb.x0, jb.y0, T=T, key=key)
    replay = JaxReplay(run_leaf_keys(key, T, 3, 1), M)
    with pytest.MonkeyPatch.context() as mp:
        margins = record_quant_margins(mp)
        ps, pm = run(pb.problem, ptopo.ring(M), C2DFBConfig(**cfg_kw), pb.x0, pb.y0, T=T,
                     generator=replay, device="cpu", transport=DeviceTransport())
    assert replay.draws == 4 * 3 * T and min(margins) > 1e-5
    _states_close(ps, js)
    np.testing.assert_array_equal(pm["measured_bytes"], np.asarray(jm["measured_bytes"]))
