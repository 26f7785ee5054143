"""The port's core modules against a live run of the JAX reference: trees,
topologies, gossip, task data, per-node oracles, compressors, wire codecs,
and the Algorithm 2 invariants (Eq. 7 mean dynamics, Prop. 4 tracking)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.core.compression import make_compressor as j_make_compressor
from repro.core.gossip import mix_delta_dense as j_mix_delta_dense
from repro.core.inner_loop import compress_stacked as j_compress_stacked
from repro.data import bilevel_tasks as jtasks
from repro.net import wire as jwire
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.compression import Identity, KernelBlockTopK, TopK, make_compressor
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.gossip import mix_delta_dense
from repro_torch.core.inner_loop import (
    compress_stacked,
    inner_init,
    inner_step,
    refresh_tracker,
)
from repro_torch.data import bilevel_tasks as ptasks
from repro_torch.net import wire as pwire

RTOL = 1e-5


# ---------------------------------------------------------------- topology


@pytest.mark.parametrize("name", ["ring", "two_hop", "complete", "star"])
@pytest.mark.parametrize("m", [2, 3, 5, 8, 10])
def test_topology_W_equals_reference(name, m):
    want = getattr(jtopo, name)(m)
    got = getattr(ptopo, name)(m)
    np.testing.assert_array_equal(got.W, want.W)
    assert got.neighbors == want.neighbors
    assert got.ppermute_schedule == want.ppermute_schedule
    assert got.spectral_gap == want.spectral_gap
    assert got.rho_prime == want.rho_prime


@pytest.mark.parametrize("m", [6, 9, 12])
def test_torus_and_factory_equal_reference(m):
    want = jtopo.make_topology("torus2d", m)
    got = ptopo.make_topology("torus2d", m)
    np.testing.assert_array_equal(got.W, want.W)
    assert got.neighbors == want.neighbors
    for name in ("ring", "two_hop", "complete", "star"):
        np.testing.assert_array_equal(
            ptopo.make_topology(name, m).W, jtopo.make_topology(name, m).W
        )


def test_erdos_renyi_waits_and_unknown_names_raise():
    with pytest.raises(ValueError, match="erdos_renyi"):
        ptopo.make_topology("er", 6)
    with pytest.raises(ValueError, match="unknown topology"):
        ptopo.make_topology("hypercube", 6)


def test_disconnected_graph_is_refused():
    W = ptopo.metropolis_weights([(0, 1), (2, 3)], 4)
    with pytest.raises(ValueError, match="connected"):
        ptopo.Topology("split", 4, W, ((1,), (0,), (3,), (2,))).validate()


# ---------------------------------------------------------------- trees


def _hyper_tree(rng, m=3):
    return {
        "w1": rng.normal(size=(m, 4, 5)).astype(np.float32),
        "b1": rng.normal(size=(m, 5)).astype(np.float32),
        "w2": rng.normal(size=(m, 5, 5)).astype(np.float32),
        "b2": rng.normal(size=(m, 5)).astype(np.float32),
    }


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(0)
    tree = _hyper_tree(rng)
    jt = jax.tree.map(jnp.asarray, tree)
    pt = from_numpy(tree)
    for a, b in zip(ptypes.tree_leaves(pt), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        float(ptypes.consensus_error(pt)), float(jtypes.consensus_error(jt)), rtol=RTOL
    )
    np.testing.assert_allclose(
        ptypes.node_consensus_dist(pt).numpy(), np.asarray(jtypes.node_consensus_dist(jt)), rtol=RTOL
    )
    assert ptypes.tree_count(pt) == jtypes.tree_count(jt)
    single = {k: v[0] for k, v in tree.items()}
    got = ptypes.broadcast_nodes(from_numpy(single), 4)
    want = jtypes.broadcast_nodes(jax.tree.map(jnp.asarray, single), 4)
    for a, b in zip(ptypes.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mix_delta_dense_matches_reference(dtype):
    rng = np.random.default_rng(1)
    topo = jtopo.two_hop(6)
    x = {"a": rng.normal(size=(6, 3, 5)).astype(np.float32), "b": rng.normal(size=(6, 7)).astype(np.float32)}
    jx = jax.tree.map(jnp.asarray, x)
    px = from_numpy(x)
    if dtype == "bf16":
        jx = jax.tree.map(lambda v: v.astype(jnp.bfloat16), jx)
        px = ptypes.tree_map(lambda v: v.to(torch.bfloat16), px)
    want = j_mix_delta_dense(jnp.asarray(topo.W, jnp.float32), jx)
    got = mix_delta_dense(torch.as_tensor(topo.W, dtype=torch.float32), px)
    for a, b in zip(ptypes.tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        # f32 sums in another order; bf16 output may then round one ulp apart
        tol = dict(rtol=1e-5, atol=1e-6) if dtype == "f32" else dict(rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(to_numpy(a), np.asarray(b, np.float32), **tol)


# ---------------------------------------------------------------- tasks + oracles


TASKS = {
    "coef": (jtasks.coefficient_tuning_task, ptasks.coefficient_tuning_task,
             dict(m=4, n=200, p=64, c=4, h=0.8, seed=1)),
    "hyper": (jtasks.hyper_representation_task, ptasks.hyper_representation_task,
              dict(m=4, n=200, side=5, hidden=6, c=3, h=0.5, seed=2)),
}


@pytest.fixture(scope="module", params=sorted(TASKS))
def task_pair(request):
    jb_fn, pb_fn, kw = TASKS[request.param]
    return jb_fn(**kw), pb_fn(**kw, device="cpu")


def test_task_data_equal_bit_for_bit(task_pair):
    jb, pb = task_pair
    for jd, pd in ((jb.problem.data_f, pb.problem.data_f), (jb.problem.data_g, pb.problem.data_g)):
        np.testing.assert_array_equal(pd["a"].numpy(), np.asarray(jd["a"]))
        np.testing.assert_array_equal(pd["b"].numpy(), np.asarray(jd["b"]))
    np.testing.assert_array_equal(pb.test_data[0].numpy(), np.asarray(jb.test_data[0]))
    for a, b in zip(ptypes.tree_leaves(pb.x0), jax.tree.leaves(jb.x0)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32


def test_oracles_per_node_match_reference(task_pair):
    jb, pb = task_pair
    rng = np.random.default_rng(4)
    jx, jy = jb.x0, jb.y0
    jz = jax.tree.map(lambda v: v + 0.05 * jnp.asarray(rng.normal(size=v.shape), v.dtype), jy)
    px, py, pz = from_numpy(jx), from_numpy(jy), from_numpy(jz)
    lam = 3.0
    pairs = [
        (pb.problem.grad_y_h(lam)(py, px), jb.problem.grad_y_h(lam)(jy, jx)),
        (pb.problem.grad_y_g()(pz, px), jb.problem.grad_y_g()(jz, jx)),
        (pb.problem.hyper_grad(px, py, pz, lam), jb.problem.hyper_grad(jx, jy, jz, lam)),
    ]
    for got, want in pairs:
        for a, b in zip(ptypes.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-7)
    assert pb.problem.oracle_calls == {"ll_grad": 2, "ul_grad": 3}


def test_evaluation_helpers_match_reference():
    kw = dict(m=3, n=120, p=16, c=3, h=0.5, seed=3)
    jb = jtasks.coefficient_tuning_task(**kw)
    pb = ptasks.coefficient_tuning_task(**kw, device="cpu")
    jx, jy = jtypes.node_mean(jb.x0), jtypes.node_mean(jb.y0)
    px, py = from_numpy(jx), from_numpy(jy)
    for name in ("mean_f", "mean_g"):
        np.testing.assert_allclose(
            float(getattr(pb.problem, name)(px, py)), float(getattr(jb.problem, name)(jx, jy)), rtol=RTOL
        )
    np.testing.assert_allclose(
        float(pb.problem.psi(px, py, ll_steps=5)), float(jb.problem.psi(jx, jy, ll_steps=5)), rtol=1e-4
    )


# ---------------------------------------------------------------- compressors + codecs


@pytest.mark.parametrize("name", ["identity", "topk", "block_topk", "kernel_topk"])
def test_compressors_match_reference(name):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 9, 31)).astype(np.float32)
    kw = dict(ratio=0.3, block=128)
    want = j_compress_stacked(j_make_compressor(name, **kw), jax.random.PRNGKey(0), jnp.asarray(x))
    comp = make_compressor(name, **kw)
    got = compress_stacked(comp, None, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert comp.tree_wire_bytes(torch.from_numpy(x[0])) == j_make_compressor(name, **kw).tree_wire_bytes(x[0])


def test_other_compressors_are_not_ported_yet():
    for name in ("randk", "quant", "kernel_quant", "lowrank"):
        with pytest.raises(ValueError, match="unknown compressor"):
            make_compressor(name)


def _sparse_leaves():
    rng = np.random.default_rng(8)
    out = []
    for d, p in ((1, 1.0), (300, 0.2), (2500, 0.05), (1024, 0.0)):
        q = np.where(rng.random(d) < p, rng.normal(size=d), 0.0).astype(np.float32)
        out.append(q)
    out[1][::7] = -0.0
    return out


@pytest.mark.parametrize(
    "pcodec, jcodec",
    [
        (pwire.DenseCodec(), jwire.DenseCodec()),
        (pwire.SparseCodec(), jwire.SparseCodec()),
        (pwire.BlockSparseCodec(block=256), jwire.BlockSparseCodec(block=256)),
    ],
    ids=["dense", "sparse", "block_sparse"],
)
def test_encode_returns_the_reference_byte_strings(pcodec, jcodec):
    for q in _sparse_leaves():
        payload = pcodec.encode(torch.from_numpy(q))
        assert payload == jcodec.encode(q)
        assert payload == pcodec.encode(q)  # numpy input too
        np.testing.assert_array_equal(pcodec.decode(payload), q)


@pytest.mark.parametrize("name", ["identity", "topk", "kernel_topk"])
def test_scan_tree_bytes_and_tree_bytes_match_reference(name):
    rng = np.random.default_rng(9)
    tree = _hyper_tree(rng, m=4)
    comp = j_make_compressor(name, ratio=0.3, block=128)
    q = j_compress_stacked(comp, jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, tree))
    pcomp = make_compressor(name, ratio=0.3, block=128)
    pq = from_numpy(q)
    assert int(pwire.scan_tree_bytes(pcomp, pq)) == int(jwire.scan_tree_bytes(comp, q))
    for i in range(4):
        one = ptypes.tree_map(lambda v: v[i], pq)
        assert pwire.measure_tree_bytes(pcomp, one) == jwire.measure_tree_bytes(
            comp, jax.tree.map(lambda v: v[i], q)
        )
    assert pwire.has_exact_codec(pcomp) == jwire.has_exact_codec(comp)


# ---------------------------------------------------------------- Algorithm 2 invariants

M, D = 8, 24


def make_quadratic(m=M, d=D, seed=0, hetero=1.0):
    """Per-node strongly-convex quadratics r_i(w) = 0.5||w - b_i||^2_{A_i}."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(m, d, d))
    A = torch.as_tensor(np.einsum("mij,mkj->mik", Q, Q) / d + 0.5 * np.eye(d), dtype=torch.float32)
    b = torch.as_tensor(hetero * rng.normal(size=(m, d)), dtype=torch.float32)

    def grad_fn(w):  # node-stacked (m, d)
        return torch.einsum("mij,mj->mi", A, w - b)

    return grad_fn


def _d0():
    return torch.as_tensor(np.random.default_rng(1).normal(size=(M, D)), dtype=torch.float32)


@pytest.mark.parametrize(
    "comp", [Identity(), TopK(ratio=0.3), KernelBlockTopK(ratio=0.3, block=128)],
    ids=["identity", "topk", "kernel_topk"],
)
def test_mean_dynamics_eq7(comp):
    """d_bar^{k+1} = d_bar^k - eta s_bar^k, independent of compression."""
    grad_fn = make_quadratic()
    W = torch.as_tensor(ptopo.ring(M).W, dtype=torch.float32)
    st = inner_init(_d0(), grad_fn)
    eta, gamma = 0.05, 0.5
    for _ in range(5):
        d_bar, s_bar = ptypes.node_mean(st.d), ptypes.node_mean(st.s)
        st = inner_step(st, None, grad_fn, W, comp, gamma, eta)
        np.testing.assert_allclose(
            ptypes.node_mean(st.d).numpy(), (d_bar - eta * s_bar).numpy(), atol=1e-5
        )


def test_tracking_invariant_prop4():
    """s_bar^k == (1/m) sum_i grad_i(d_i^k) at every step."""
    grad_fn = make_quadratic()
    W = torch.as_tensor(ptopo.ring(M).W, dtype=torch.float32)
    st = inner_init(_d0(), grad_fn)
    comp = TopK(ratio=0.3)
    for _ in range(6):
        np.testing.assert_allclose(
            ptypes.node_mean(st.s).numpy(), ptypes.node_mean(grad_fn(st.d)).numpy(), atol=1e-4
        )
        st = inner_step(st, None, grad_fn, W, comp, 0.5, 0.05)


def test_refresh_preserves_tracking_after_objective_change():
    grad_a, grad_b = make_quadratic(seed=0), make_quadratic(seed=1)
    W = torch.as_tensor(ptopo.ring(M).W, dtype=torch.float32)
    st = inner_init(_d0(), grad_a)
    st = inner_step(st, None, grad_a, W, Identity(), 0.5, 0.05)
    st = refresh_tracker(st, grad_b)
    np.testing.assert_allclose(
        ptypes.node_mean(st.s).numpy(), ptypes.node_mean(grad_b(st.d)).numpy(), atol=1e-4
    )
