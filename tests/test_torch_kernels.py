"""The port's kernel modules on the CPU: the plain versions of B1 (block
top-k), B2 (pack), B3 (unpack) and B4 (stochastic quantizer) against the
Pallas kernels run in interpret mode and against the reference's jnp
oracle, bit for bit; the wrappers' blocking per node, shapes and
contraction.  The CUDA kernels themselves are held to these plain versions
on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import KernelBlockTopK as JKernelBlockTopK
from repro.core.compression import KernelQuant as JKernelQuant
from repro.core.inner_loop import compress_stacked as j_compress_stacked
from repro.kernels.ops import block_topk as j_block_topk
from repro.kernels.pack_residuals import pack_sparse_blocks as j_pack
from repro.kernels.pack_residuals import unpack_sparse_blocks as j_unpack
from repro.kernels.quantize import quantize_pallas
from repro.kernels.ref import block_topk_ref as j_block_topk_ref
from repro.kernels.ref import quantize_ref as j_quantize_ref
from repro.kernels.topk_compress import block_topk_pallas
from repro_torch.core.compression import KernelBlockTopK, KernelQuant
from repro_torch.kernels.ops import block_topk, block_topk_nodes, quantize, quantize_nodes
from repro_torch.kernels.pack_residuals import (
    pack_sparse_blocks,
    padded_k,
    unpack_sparse_blocks,
)
from repro_torch.kernels.quantize import quantize_kernel
from repro_torch.kernels.ref import block_topk_ref, quantize_ref
from repro_torch.kernels.topk_compress import block_topk_kernel, block_topk_leaf

from _torch_replay import JaxReplay, message_leaf_keys

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a float array (f32 or bf16)."""
    a = np.asarray(a)
    return a.view(np.int32 if a.dtype.itemsize == 4 else np.int16)


def _same_inputs(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.view(torch.int32).numpy()


def _edge_rows(block: int, seed: int) -> np.ndarray:
    """(16, block) f32 rows: a NaN lane beside a -0.0 lane; +inf and -inf
    lanes; all zeros; ties from {-1, 0, 1}; a third of the lanes -0.0; then
    normal rows at scales from 0.01 to 10.  No subnormals: JAX on the CPU
    flushes them to zero, so the card alone checks those (chip_smoke.py)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(16, block)) * rng.uniform(0.01, 10.0, size=(16, 1))).astype(np.float32)
    x[0, 7], x[0, 3] = np.nan, -0.0
    x[1, 5], x[1, 9] = np.inf, -np.inf
    x[2] = 0.0
    x[3] = rng.integers(-1, 2, size=block)
    x[4, ::3] = -0.0
    return x


def _k_of(kind: str, block: int) -> int:
    return {"one": 1, "ratio": int(round(0.2 * block)), "all": block}[kind]


def _np(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of its dtype (bf16 as jnp.bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _assert_same(got: np.ndarray, want: np.ndarray) -> None:
    """Equal NaN positions, equal bits everywhere else."""
    nan = np.isnan(got.astype(np.float32))
    np.testing.assert_array_equal(nan, np.isnan(want.astype(np.float32)))
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("block", [128, 384, 1024, 2048, 4096])
@pytest.mark.parametrize("k_kind", ["one", "ratio", "all"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_topk_plain_matches_pallas_and_ref_bit_for_bit(block, k_kind, dtype):
    x = _edge_rows(block, seed=block)
    xj, xt = _same_inputs(x, dtype)
    k = _k_of(k_kind, block)
    got = block_topk_kernel(xt, k)  # a CPU tensor: the plain version
    np.testing.assert_array_equal(_torch_bits(got), _torch_bits(block_topk_ref(xt, k)))
    _assert_same(_np(got), np.asarray(j_block_topk_ref(xj, k)))
    want_pallas = np.asarray(block_topk_pallas(xj, k=k, block=block, interpret=True))
    if dtype == "f32":
        # XLA fuses the interpret-mode kernel body and rewrites x * mask into
        # a select, so its dropped negatives are +0.0 where the jnp oracle
        # (and the port) give -0.0, and its NaN lanes 0.0 where they give
        # NaN; every other bit agrees
        finite = ~np.isnan(x)
        canon = lambda a: np.where(a == 0, np.float32(0), a)  # noqa: E731
        np.testing.assert_array_equal(_bits(canon(_np(got)))[finite], _bits(canon(want_pallas))[finite])
    else:
        _assert_same(_np(got), want_pallas)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_topk_row_with_a_nan_comes_back_unchanged(dtype):
    """max|x| is NaN for such a row (as jnp.max gives), every bisection mid
    is NaN and every count 0, so the threshold stays 0: every finite value
    is kept as it is (-0.0 too) and every NaN lane stays NaN."""
    x = _edge_rows(128, seed=1)[:1]
    x[0, 40] = np.nan
    xj, xt = _same_inputs(x, dtype)
    got = block_topk_kernel(xt, 26)
    assert torch.isnan(got[0, [7, 40]]).all()
    assert got[0, 3] == 0 and torch.signbit(got[0, 3])
    _assert_same(_np(got), _np(xt))
    _assert_same(_np(got), np.asarray(j_block_topk_ref(xj, 26)))


def test_topk_drops_negatives_to_negative_zero():
    x = torch.tensor([[-3.0, 2.0, -0.5, 0.25] + [0.0] * 124])
    out = block_topk_kernel(x, 2)
    assert out[0, 0] == -3.0 and out[0, 1] == 2.0
    assert torch.signbit(out[0, 2]) and out[0, 2] == 0.0
    assert not torch.signbit(out[0, 3])


def _pack_rows(block: int) -> np.ndarray:
    """Rows with -0.0 entries, an empty row, a row with more survivors than
    a kpad below block (~80% of the lanes), a row with a NaN lane, a row
    with +inf and -inf lanes, and a row of ties from {-1, 0, 1}."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, block)).astype(np.float32)
    x[0] = np.where(rng.random(block) < 0.2, x[0], 0.0)
    x[0, 1::17] = -0.0
    x[1] = 0.0  # empty row
    x[2, :] = 0.0
    x[2, [0, 5, block - 1]] = [-0.0, 4.0, -2.5]
    x[3] = np.where(rng.random(block) < 0.8, x[3], 0.0)
    x[4] = np.where(rng.random(block) < 0.35, x[4], -0.0)
    x[5] = np.where(rng.random(block) < 0.2, x[5], 0.0)
    x[5, [3, 11]] = [np.nan, -0.0]
    x[6] = np.where(rng.random(block) < 0.2, x[6], 0.0)
    x[6, [2, 9]] = [np.inf, -np.inf]
    x[7] = rng.integers(-1, 2, size=block)
    return x


@pytest.mark.parametrize("block", [128, 256, 1024, 4096])
@pytest.mark.parametrize("k_kind", ["one", "ratio", "all"])
def test_pack_and_unpack_plain_match_pallas_exactly(block, k_kind):
    """Bit for bit against the Pallas kernels, except on rows holding a NaN
    or an inf, whose values the reference's one-hot matmul turns all NaN
    (0 * inf is NaN); there the records hold each survivor as it is, in lane
    order, and unpack restores them."""
    k = _k_of(k_kind, block)
    kpad = padded_k(k)
    x = _pack_rows(block)
    vj, ij = j_pack(jnp.asarray(x), k=k, block=block, interpret=True)
    vt, it = pack_sparse_blocks(torch.from_numpy(x), k, block)
    assert vt.shape == (8, kpad) and vt.dtype == torch.float32
    assert it.dtype == torch.int32
    if kpad < block:
        assert (np.count_nonzero(x, axis=1) > kpad).any()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    finite = np.isfinite(x).all(axis=1)
    np.testing.assert_array_equal(_torch_bits(vt)[finite], _bits(vj)[finite])
    uj = np.asarray(j_unpack(vj, ij, block=block, interpret=True))
    ut = unpack_sparse_blocks(vt, it, block)
    np.testing.assert_array_equal(_torch_bits(ut)[finite], _bits(uj)[finite])
    for row in np.flatnonzero(~finite):
        lanes = np.flatnonzero(x[row] != 0)[:kpad]
        want = np.zeros(kpad, np.float32)
        want[: lanes.size] = x[row, lanes]
        _assert_same(_np(vt[row]), want)
        kept = np.zeros(block, np.float32)
        kept[lanes] = x[row, lanes]
        _assert_same(_np(ut[row]), kept)


def test_unpack_inverts_pack_when_survivors_fit():
    block = 128
    rng = np.random.default_rng(5)
    x = np.where(rng.random((7, block)) < 0.15, rng.normal(size=(7, block)), 0.0).astype(np.float32)
    k = int(np.count_nonzero(x, axis=1).max())
    vals, idx = pack_sparse_blocks(torch.from_numpy(x), k, block)
    back = unpack_sparse_blocks(vals, idx, block)
    np.testing.assert_array_equal(back.numpy(), x)


def test_unpack_sums_duplicates_and_ignores_out_of_range_indices():
    vals = torch.zeros((1, 128))
    idx = torch.full((1, 128), 128, dtype=torch.int32)
    vals[0, :4] = torch.tensor([1.0, 2.0, 4.0, 8.0])
    idx[0, :4] = torch.tensor([3, 3, -1, 200], dtype=torch.int32)
    out = unpack_sparse_blocks(vals, idx, 128)
    want = np.asarray(j_unpack(jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()), block=128, interpret=True))
    np.testing.assert_array_equal(out.numpy(), want)
    assert out[0, 3] == 3.0 and out.sum() == 3.0


@pytest.mark.parametrize("shape", [(100,), (3, 7, 11), (1025,), (4096,)])
def test_block_topk_wrapper_arbitrary_shapes(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    out = block_topk(torch.from_numpy(x), ratio=0.25, block=128)
    assert out.shape == shape
    want = np.asarray(j_block_topk(jnp.asarray(x), ratio=0.25, block=128))
    np.testing.assert_array_equal(out.numpy() != 0, want != 0)
    np.testing.assert_array_equal(out.numpy()[want != 0], want[want != 0])
    mask = out.numpy() != 0
    np.testing.assert_array_equal(out.numpy()[mask], x[mask])


def test_blocks_are_cut_per_node():
    """Node i's result equals compressing node i alone (no block straddles
    two nodes), and equals the reference's vmapped compressor."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 5, 41)).astype(np.float32)  # 205 values a node
    xt = torch.from_numpy(x)
    out = block_topk_nodes(xt, ratio=0.2, block=128)
    for i in range(3):
        np.testing.assert_array_equal(out[i].numpy(), block_topk(xt[i], 0.2, 128).numpy())
    want = np.asarray(
        j_compress_stacked(JKernelBlockTopK(ratio=0.2, block=128), jax.random.PRNGKey(0), jnp.asarray(x))
    )
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(KernelBlockTopK(0.2, 128).compress_nodes(xt).numpy(), want)


@pytest.mark.parametrize("d", [100, 205, 1028])
def test_leaf_entry_matches_padded_tiles_and_the_reference(d):
    """block_topk_leaf on an (m, d) leaf whose d is no multiple of block
    equals block top-k of each node's zero-padded tiles, block_topk_nodes,
    and the reference's vmapped compressor."""
    block, k = 128, 26
    rng = np.random.default_rng(d)
    flat = rng.normal(size=(3, d)).astype(np.float32)
    flat[2, 128:] = 0.0  # an all-zero partial last block where d > 128
    ft = torch.from_numpy(flat)
    got = block_topk_leaf(ft, k, block)
    assert got.shape == (3, d)
    nb = -(-d // block)
    tiles = np.zeros((3, nb * block), np.float32)
    tiles[:, :d] = flat
    want = block_topk_kernel(torch.from_numpy(tiles).reshape(3 * nb, block), k).reshape(3, -1)[:, :d]
    np.testing.assert_array_equal(_torch_bits(got.contiguous()), _torch_bits(want.contiguous()))
    np.testing.assert_array_equal(_torch_bits(block_topk_nodes(ft, k / block, block)), _torch_bits(got.contiguous()))
    # the reference's compressor runs the Pallas kernel (dropped negatives
    # +0.0, see above): equal values
    jwant = j_compress_stacked(JKernelBlockTopK(ratio=k / block, block=block), jax.random.PRNGKey(0), jnp.asarray(flat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_kernel_compressor_contractive():
    comp = KernelBlockTopK(ratio=0.25, block=128)
    rng = np.random.default_rng(2)
    for _ in range(5):
        x = torch.from_numpy(rng.normal(size=(777,)).astype(np.float32))
        q = comp(x)
        r = float(torch.sum((q - x) ** 2) / torch.sum(x**2))
        assert r <= 1.0 - comp.delta + 1e-5


def test_topk_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        block_topk_kernel(torch.zeros((2, 100)), 4)
    with pytest.raises(TypeError):
        block_topk_kernel(torch.zeros((2, 128), dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        pack_sparse_blocks(torch.zeros((2, 128)), 0, 128)
    with pytest.raises(TypeError):
        unpack_sparse_blocks(torch.zeros((2, 128)), torch.zeros((2, 128), dtype=torch.int64), 128)


# ---------------------------------------------------------------- B4: quantizer


def _quant_inputs(nb, block, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(nb, block)) * rng.uniform(0.01, 10.0, size=(nb, 1))).astype(np.float32)
    u = rng.random((nb, block), dtype=np.float32)
    return x, u


@pytest.mark.parametrize("nb", [1, 5, 16])
@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_plain_matches_jnp_oracle_bit_for_bit(nb, block, bits):
    x, u = _quant_inputs(nb, block, seed=nb * 31 + block + bits)
    out, scales = quantize_kernel(torch.from_numpy(x), torch.from_numpy(u), bits)  # CPU: plain
    rout, rscales = quantize_ref(torch.from_numpy(x), torch.from_numpy(u), bits)
    assert scales.shape == (nb, 1) and out.dtype == torch.float32
    np.testing.assert_array_equal(_torch_bits(out), _torch_bits(rout))
    jout, jscales = j_quantize_ref(jnp.asarray(x), jnp.asarray(u), bits)
    np.testing.assert_array_equal(_torch_bits(out), _bits(jout))
    np.testing.assert_array_equal(_torch_bits(scales), _bits(jscales))


@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_plain_matches_pallas_within_an_ulp(block, bits):
    """XLA fuses the interpret-mode kernel body and rounds its dequant
    epilogue ((q / levels) * 2 - 1) * scale differently from the op-by-op
    oracle, so values may differ by about one ulp of the scale (seen: up to
    7.2e-7 relative); scales and codes are equal."""
    x, u = _quant_inputs(16, block, seed=block + bits)
    out, scales = quantize_kernel(torch.from_numpy(x), torch.from_numpy(u), bits)
    pout, pscales = quantize_pallas(jnp.asarray(x), jnp.asarray(u), bits=bits, block=block, interpret=True)
    pout, pscales = np.asarray(pout), np.asarray(pscales)
    np.testing.assert_array_equal(_torch_bits(scales), _bits(pscales))
    levels = (1 << bits) - 1
    codes = lambda v, s: np.rint((v / s + 1.0) * 0.5 * levels)  # noqa: E731
    np.testing.assert_array_equal(codes(out.numpy(), scales.numpy()), codes(pout, pscales))
    np.testing.assert_allclose(out.numpy(), pout, rtol=0, atol=float(pscales.max()) * 2.0**-21)


def test_quantize_nan_and_zero_rows_behave_as_the_oracle():
    x, u = _quant_inputs(3, 128, seed=9)
    x[0, 17] = np.nan
    x[1] = 0.0
    out, scales = quantize_kernel(torch.from_numpy(x), torch.from_numpy(u), 4)
    jout, jscales = j_quantize_ref(jnp.asarray(x), jnp.asarray(u), 4)
    jout, jscales = np.asarray(jout), np.asarray(jscales)
    assert np.isnan(scales[0, 0].item()) and np.isnan(out[0].numpy()).all()
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(jout))
    np.testing.assert_array_equal(np.nan_to_num(out.numpy()), np.nan_to_num(jout))
    np.testing.assert_array_equal(np.nan_to_num(scales.numpy()), np.nan_to_num(jscales))
    # an all-zero row: the scale clamps to 1e-12 and values land on its grid
    assert scales[1, 0] == np.float32(1e-12)
    assert (out[1].abs() > 0).all() and (out[1].abs() <= np.float32(1e-12)).all()


def test_quantize_blocks_are_cut_per_node():
    """Node i's result equals quantizing node i alone on its own samples,
    and equals the reference's vmapped compressor on its own draws."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 5, 41)).astype(np.float32)  # 205 values a node: 2 blocks of 128
    xt = torch.from_numpy(x)
    u = torch.from_numpy(rng.random((3 * 2, 128), dtype=np.float32))
    out = quantize_nodes(xt, u, bits=4, block=128)
    for i in range(3):
        np.testing.assert_array_equal(out[i].numpy(), quantize(xt[i], u[2 * i : 2 * i + 2], 4, 128).numpy())
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_compress_stacked(JKernelQuant(bits=4, block=128), key, jnp.asarray(x)))
    got = KernelQuant(bits=4, block=128).compress_nodes(xt, JaxReplay(message_leaf_keys(key, 1), 3))
    # the reference's Pallas epilogue is fused (see the test above)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=float(np.abs(x).max()) * 2.0**-21)


def _bf16_inputs(nb, block, seed):
    """The f32 inputs rounded to bf16, as jnp and torch tensors of the same
    bits; the samples come from ``jax.random.uniform`` in bf16."""
    x, _ = _quant_inputs(nb, block, seed)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ju = jax.random.uniform(jax.random.PRNGKey(seed), (nb, block), jnp.bfloat16)
    as_torch = lambda a: torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)  # noqa: E731
    return jx, ju, as_torch(jx), as_torch(ju)


@pytest.mark.parametrize("nb", [1, 5, 16])
@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_bf16_plain_matches_jnp_oracle_bit_for_bit(nb, block, bits):
    """bf16 in, bf16 values and (nb, 1) bf16 scales out, equal bit for bit to
    the reference's op-by-op (un-jitted) jnp oracle; NaN and all-zero rows
    too."""
    jx, ju, x, u = _bf16_inputs(nb, block, seed=nb * 31 + block + bits)
    if nb > 1:
        jx = jx.at[0, 17].set(jnp.nan).at[1].set(0.0)
        x[0, 17], x[1] = float("nan"), 0.0
    out, scales = quantize_kernel(x, u, bits)  # CPU: plain
    assert out.dtype == scales.dtype == torch.bfloat16 and scales.shape == (nb, 1)
    jout, jscales = j_quantize_ref(jx, ju, bits)
    _assert_same(_np(out), np.asarray(jout))
    _assert_same(_np(scales), np.asarray(jscales))


@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_bf16_plain_matches_pallas_within_a_bf16_ulp(block, bits):
    """XLA on the CPU may keep f32 between the fused ops of the interpret-mode
    kernel (excess precision), so its bf16 values may differ from the op-by-op
    chain; the bound is one bf16 ulp of the row's scale (scale * 2^-7), with
    equal scales."""
    jx, ju, x, u = _bf16_inputs(16, block, seed=block + bits + 1)
    out, scales = quantize_kernel(x, u, bits)
    pout, pscales = quantize_pallas(jx, ju, bits=bits, block=block, interpret=True)
    np.testing.assert_array_equal(_bits(_np(scales)), _bits(np.asarray(pscales)))
    diff = np.abs(_np(out).astype(np.float32) - np.asarray(pout).astype(np.float32))
    assert (diff <= np.asarray(pscales).astype(np.float32) * 2.0**-7).all()


def test_kernel_quant_on_a_bf16_leaf_matches_the_reference():
    """KernelQuant on a (2, 300) bf16 leaf (bits 4, block 128) draws its
    samples in bf16, as the reference does, and returns a bf16 result equal
    to the reference's on the replayed draws (within one bf16 ulp of each
    block's scale: the reference runs the Pallas kernel)."""
    rng = np.random.default_rng(5)
    jx = jnp.asarray(rng.normal(size=(2, 300)).astype(np.float32)).astype(jnp.bfloat16)
    x = torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(torch.bfloat16)
    key = jax.random.PRNGKey(11)
    want = np.asarray(j_compress_stacked(JKernelQuant(bits=4, block=128), key, jx))
    got = KernelQuant(bits=4, block=128).compress_nodes(x, JaxReplay(message_leaf_keys(key, 1), 2))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 300) and want.dtype == jnp.bfloat16
    diff = np.abs(_np(got).astype(np.float32) - want.astype(np.float32))
    assert (diff <= float(np.abs(np.asarray(jx).astype(np.float32)).max()) * 2.0**-7).all()
    # a torch.Generator draws bf16 samples in [0, 1) too
    out = KernelQuant(bits=4, block=128).compress_nodes(x, torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())


def test_quantize_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 128))
    with pytest.raises(ValueError):
        quantize_kernel(torch.zeros((2, 100)), torch.zeros((2, 100)), 4)
    with pytest.raises(ValueError):
        quantize_kernel(x, torch.zeros((2, 256)), 4)
    with pytest.raises(ValueError):
        quantize_kernel(torch.zeros(128), torch.zeros(128), 4)
    with pytest.raises(TypeError):
        quantize_kernel(x.double(), x.double(), 4)
    with pytest.raises(TypeError):
        quantize_kernel(x.to(torch.bfloat16), x, 4)
    for bits in (0, 9):
        with pytest.raises(ValueError):
            quantize_kernel(x, x, bits)
    with pytest.raises(ValueError, match="cpu or cuda"):
        quantize_kernel(x.to("meta"), x.to("meta"), 4)
