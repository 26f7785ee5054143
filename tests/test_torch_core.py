"""The port's core modules against a live run of the JAX reference: trees,
topologies, gossip, task data, per-node oracles, compressors (the
stochastic ones fed the reference's own draws), wire codecs, and the
Algorithm 2 invariants (Eq. 7 mean dynamics, Prop. 4 tracking)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopo
from repro.core import types as jtypes
from repro.core import compression as jcomp
from repro.core.compression import make_compressor as j_make_compressor
from repro.core.gossip import mix_delta_dense as j_mix_delta_dense
from repro.core.inner_loop import compress_stacked as j_compress_stacked
from repro.data import bilevel_tasks as jtasks
from repro.net import wire as jwire
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core import compression as pcomp
from repro_torch.core.compression import Identity, KernelBlockTopK, KernelQuant, TopK, make_compressor
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

from _torch_replay import JaxReplay, message_leaf_keys

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
    """'er' no longer waits: it draws the reference's graph (more cases in
    tests/test_torch_net.py); unknown names still raise."""
    got, want = ptopo.make_topology("er", 6), jtopo.make_topology("er", 6)
    assert got.name == want.name and got.neighbors == want.neighbors
    np.testing.assert_array_equal(got.W, want.W)
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


def _jax_q0(cols, r):
    """The reference LowRank's fixed test matrix."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), (cols, r), jnp.float32)))


KW = dict(ratio=0.3, block=128, bits=4)
# name -> (reference compressor, port compressor, tolerance of the outputs)
COMPRESSORS = {
    **{n: (j_make_compressor(n, **KW), make_compressor(n, **KW), None)
       for n in ("identity", "topk", "block_topk", "kernel_topk", "randk", "quant")},
    # the reference's Pallas quantizer rounds its fused epilogue differently
    # from the op-by-op oracle the port follows: about an ulp of the scale
    "kernel_quant": (j_make_compressor("kernel_quant", **KW), make_compressor("kernel_quant", **KW), "ulp"),
    # QR and matmuls in another order (BLAS); P P^T M is sign-free
    "lowrank": (jcomp.LowRank(rank=4), pcomp.LowRank(rank=4, test_matrix=_jax_q0), dict(rtol=1e-5, atol=1e-6)),
    "rescaled_quant": (jcomp.Rescaled(jcomp.StochasticQuant(bits=4)),
                       pcomp.Rescaled(pcomp.StochasticQuant(bits=4)), None),
}


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_compressors_match_reference(name):
    """Every compressor on a node-stacked leaf, the stochastic ones drawing
    the reference's own samples through the replay source."""
    jc, pc, tol = COMPRESSORS[name]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 9, 31)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(j_compress_stacked(jc, key, jnp.asarray(x)))
    replay = JaxReplay(message_leaf_keys(key, 1), m=3)
    got = compress_stacked(pc, replay, torch.from_numpy(x)).numpy()
    if tol is None:
        np.testing.assert_array_equal(got, want)
    elif tol == "ulp":
        np.testing.assert_allclose(got, want, rtol=0, atol=float(np.abs(x).max()) * 2.0**-21)
    else:
        np.testing.assert_allclose(got, want, **tol)
    assert pc.tree_wire_bytes(torch.from_numpy(x[0])) == jc.tree_wire_bytes(x[0])
    assert pc.delta == jc.delta


@pytest.mark.parametrize("name", ["randk", "quant", "kernel_quant", "rescaled_quant"])
def test_stochastic_compressors_need_a_random_source(name):
    pc = COMPRESSORS[name][1]
    drawer = pc.inner if isinstance(pc, pcomp.Rescaled) else pc  # the error names who draws
    with pytest.raises(ValueError, match=type(drawer).__name__):
        pc(torch.ones(256), None)
    q = pc(torch.ones(256), torch.Generator().manual_seed(0))  # a torch.Generator is wrapped
    assert q.shape == (256,)


@pytest.mark.parametrize("name", ["topk", "randk", "quant", "kernel_quant", "lowrank"])
def test_empirical_contraction_matches_reference(name):
    jc, pc, tol = COMPRESSORS[name]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(777,)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = float(jcomp.empirical_contraction(jc, key, jnp.asarray(x)))
    # compressor(key, x) on one leaf: the node key is the key itself
    leaf_key = jax.random.split(jax.random.PRNGKey(99), 1)[0]

    class OneKey(JaxReplay):
        def _next_node_keys(self):
            return [key]

    got = float(pcomp.empirical_contraction(pc, OneKey([leaf_key], m=1), torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if name in ("topk", "lowrank"):  # deterministic: the bound holds for every draw
        assert got <= 1.0 - pc.delta + 1e-5


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


def _quant_leaves():
    """(bits, q): one-row quantizer outputs of odd sizes (a partial last
    block at block 256), and raw values (bits None)."""
    rng = np.random.default_rng(10)
    out = []
    for bits, d in ((2, 1), (4, 300), (8, 1000), (4, 513)):
        x = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32))
        u = torch.from_numpy(rng.random((1, d), dtype=np.float32))
        out.append((bits, pcomp.quantize_ref(x, u, bits)[0][0].numpy()))
    out.append((None, rng.normal(size=77).astype(np.float32)))
    return out


@pytest.mark.parametrize("block", [0, 256])
def test_quant_codec_returns_the_reference_byte_strings(block):
    for bits, q in _quant_leaves():
        for b in (2, 4, 8):
            pc, jc = pwire.QuantCodec(bits=b, block=block), jwire.QuantCodec(bits=b, block=block)
            payload = pc.encode(torch.from_numpy(q))
            assert payload == jc.encode(q)
            assert pc.measure(q) == jc.measure(q)
            np.testing.assert_array_equal(pc.decode(payload), jc.decode(payload))
            assert pc.encode(pc.decode(payload)) == payload
        if block == 0 and bits is not None:  # a quantizer output of one scale decodes bit for bit
            codec = pwire.QuantCodec(bits=bits)
            np.testing.assert_array_equal(codec.decode(codec.encode(q)), q)


def _chunk_tree(rng):
    tree = _hyper_tree(rng, m=1)
    return {k: np.where(rng.random(v[0].shape) < 0.3, v[0], 0.0).astype(np.float32) for k, v in tree.items()}


CHUNK_CODECS = {
    "dense": (pwire.DenseCodec(), jwire.DenseCodec()),
    "sparse": (pwire.SparseCodec(), jwire.SparseCodec()),
    "block_sparse": (pwire.BlockSparseCodec(block=128), jwire.BlockSparseCodec(block=128)),
}


@pytest.mark.parametrize("codec", sorted(CHUNK_CODECS))
@pytest.mark.parametrize("chunk", [7, 32, 1 << 16])
def test_chunked_tree_path_is_byte_identical(codec, chunk):
    pc, jc = CHUNK_CODECS[codec]
    tree = _chunk_tree(np.random.default_rng(chunk))
    ptree = from_numpy(tree)
    payloads = pc.encode_tree_chunked(ptree, chunk)
    assert payloads == jc.encode_tree_chunked(tree, chunk)
    assert pc.tree_bytes_chunked(ptree, chunk) == jc.tree_bytes_chunked(tree, chunk)
    back = pc.decode_tree_chunked(payloads, ptree)
    want = jc.decode_tree_chunked(payloads, tree)
    for a, b in zip(ptypes.tree_leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    comp_p, comp_j = make_compressor("topk", ratio=0.3), j_make_compressor("topk", ratio=0.3)
    assert pwire.measure_tree_bytes_chunked(comp_p, ptree, chunk) == jwire.measure_tree_bytes_chunked(comp_j, tree, chunk)
    with pytest.raises(ValueError, match="chunk"):
        pc.encode_tree_chunked(ptree, 0)


def test_chunked_quant_is_rejected_as_in_the_reference():
    tree = _chunk_tree(np.random.default_rng(1))
    for codec in (pwire.QuantCodec(bits=4, block=128), jwire.QuantCodec(bits=4, block=128)):
        with pytest.raises(ValueError, match="QuantCodec"):
            codec.encode_tree_chunked(tree if isinstance(codec, jwire.QuantCodec) else from_numpy(tree), 64)


@pytest.mark.parametrize("chunk", [50, 128, 1 << 16])
def test_packed_records_are_byte_identical(chunk):
    """Pack records of each leaf (port's pack, plain path) to chunked
    payloads: the reference's function on the same records gives the same
    bytes, which equal chunk-encoding the dense tree."""
    from repro_torch.kernels.pack_residuals import pack_sparse_blocks

    block = 128
    tree = _chunk_tree(np.random.default_rng(chunk + 1))
    leaves = jax.tree.leaves(tree)
    vals, idx, sizes = [], [], []
    for leaf in leaves:
        d = leaf.size
        tiles = torch.nn.functional.pad(torch.from_numpy(leaf).reshape(-1), (0, -d % block)).reshape(-1, block)
        k = max(1, int(torch.count_nonzero(tiles, dim=1).max()))
        v, i = pack_sparse_blocks(tiles, k, block)
        vals.append(v)
        idx.append(i)
        sizes.append(d)
    got = pwire.encode_packed_records_chunked(vals, idx, sizes, block, chunk)
    np_vals, np_idx = [v.numpy() for v in vals], [i.numpy() for i in idx]
    assert got == jwire.encode_packed_records_chunked(np_vals, np_idx, sizes, block, chunk)
    assert got == jwire.SparseCodec().encode_tree_chunked(tree, chunk)
    np.testing.assert_array_equal(
        pwire.scatter_packed_records(vals, idx, sizes, block),
        jwire.scatter_packed_records(np_vals, np_idx, sizes, block),
    )
    with pytest.raises(ValueError):
        pwire.encode_packed_records_chunked(vals, idx[:-1], sizes, block, chunk)


@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_scan_tree_bytes_and_tree_bytes_match_reference(name):
    jc, pc, _ = COMPRESSORS[name]
    rng = np.random.default_rng(9)
    tree = _hyper_tree(rng, m=4)
    key = jax.random.PRNGKey(0)
    q = j_compress_stacked(jc, key, jax.tree.map(jnp.asarray, tree))
    pq = compress_stacked(pc, JaxReplay(message_leaf_keys(key, 4), m=4), from_numpy(tree))
    assert int(pwire.scan_tree_bytes(pc, pq)) == int(jwire.scan_tree_bytes(jc, q))
    for i in range(4):
        one = ptypes.tree_map(lambda v: v[i], pq)
        assert pwire.measure_tree_bytes(pc, one) == jwire.measure_tree_bytes(
            jc, jax.tree.map(lambda v: v[i], q)
        )
    assert pwire.has_exact_codec(pc) == jwire.has_exact_codec(jc)
    pcodec, jcodec = pwire.codec_for(pc), jwire.codec_for(jc)
    assert type(pcodec).__name__ == type(jcodec).__name__
    assert dataclasses.asdict(pcodec) == dataclasses.asdict(jcodec)


@pytest.mark.parametrize("name", ["identity", "kernel_topk", "quant"])
def test_measure_compressed_tree_bytes_matches_reference(name):
    jc, pc, _ = COMPRESSORS[name]
    tree = {k: v[0] for k, v in _hyper_tree(np.random.default_rng(12), m=1).items()}
    key = jax.random.PRNGKey(2)
    want = jwire.measure_compressed_tree_bytes(jc, key, jax.tree.map(jnp.asarray, tree))

    class PerLeaf(JaxReplay):  # compress_tree: one key a leaf, used as the node key
        def _next_node_keys(self):
            return [next(self._leaf_keys)]

    got = pwire.measure_compressed_tree_bytes(pc, PerLeaf(jax.random.split(key, 4), m=1), from_numpy(tree))
    assert got == want


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
