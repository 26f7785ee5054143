"""The port's GQA attention (``repro_torch.models.attention``) against the
live reference: the nine cases of tests/test_attention.py, each run through
the reference's function and the port's on the same arrays (the reference's
``attn_init`` weights and ``jax.random`` inputs, carried across as numpy;
the port's tensors carry a node axis of 1), and each port output also held
to the case's own invariant (causality, the window, decode against prefill,
the soft-cap, the memory).  f32 configs: outputs within atol 2e-5, as the
reference's own chunked-against-unchunked check, and rtol 1e-4 (the
golden rtol: the perturbed inputs give outputs of order 100 and saturated
soft-caps).  About 5 s on one worker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import attention as JA
from repro_torch.configs.base import ModelConfig as PConfig
from repro_torch.core.convert import from_numpy
from repro_torch.core.types import tree_map
from repro_torch.models import attention as PA

KEY = jax.random.PRNGKey(0)
ATOL = 2e-5
TOL = dict(rtol=1e-4, atol=ATOL)


def cfgs(**kw):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                d_ff=128, vocab_size=64, pattern=("full",))
    base.update(kw)
    return JConfig(**base, dtype=jnp.float32), PConfig(**base, dtype=torch.float32)


def _pos(B, S):
    return jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))


def _node(tree):
    """The reference's arrays as the port's tensors with a node axis of 1."""
    return tree_map(lambda v: v.unsqueeze(0), from_numpy(tree))


def _apply_both(jcfg, pcfg, p, x, kind="full", q_chunk=1024, memory=None):
    B, S = x.shape[0], x.shape[1]
    want, (jk, _) = JA.attn_apply(p, jcfg, x, _pos(B, S), kind=kind, q_chunk=q_chunk, memory=memory)
    got, (pk, _) = PA.attn_apply(_node(p), pcfg, _node(x), torch.from_numpy(np.array(_pos(B, S))), kind=kind,
                                 q_chunk=q_chunk, memory=None if memory is None else _node(memory))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pk[0].numpy(), np.asarray(jk), **TOL)
    return got[0].numpy()


def _ref_attention(p, cfg, x, kind="full"):
    """The reference test's unchunked dense attention."""
    B, S, _ = x.shape
    q, k, v = JA._project_qkv(p, cfg, x, _pos(B, S))
    scores = JA._gqa_scores(q, k, cfg)
    i = jnp.arange(S)
    mask = i[:, None] >= i[None, :]
    if kind == "swa" and cfg.window:
        mask &= (i[:, None] - i[None, :]) < cfg.window
    scores = jnp.where(mask[None, None, None], scores, -2.0e38)
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    return JA._gqa_out(probs, v) @ p["wo"]


@pytest.mark.parametrize("S,q_chunk", [(64, 16), (128, 32), (96, 96)])
def test_chunked_matches_reference(S, q_chunk):
    jcfg, pcfg = cfgs()
    p, _ = JA.attn_init(KEY, jcfg, "full")
    x = jax.random.normal(KEY, (2, S, jcfg.d_model))
    got = _apply_both(jcfg, pcfg, p, x, "full", q_chunk)
    np.testing.assert_allclose(got, np.asarray(_ref_attention(p, jcfg, x, "full")), atol=ATOL)


def test_causality():
    """Changing a future token never changes past outputs."""
    jcfg, pcfg = cfgs()
    p, _ = JA.attn_init(KEY, jcfg, "full")
    S = 32
    x = jax.random.normal(KEY, (1, S, jcfg.d_model))
    out1 = _apply_both(jcfg, pcfg, p, x, "full", 8)
    out2 = _apply_both(jcfg, pcfg, p, x.at[0, -1].add(100.0), "full", 8)
    np.testing.assert_allclose(out1[0, :-1], out2[0, :-1], atol=1e-5)
    assert not np.allclose(out1[0, -1], out2[0, -1])


def test_sliding_window_blocks_distant_tokens():
    jcfg, pcfg = cfgs(window=8, pattern=("swa",))
    p, _ = JA.attn_init(KEY, jcfg, "swa")
    S = 64
    x = jax.random.normal(KEY, (1, S, jcfg.d_model))
    out1 = _apply_both(jcfg, pcfg, p, x, "swa", 16)
    out2 = _apply_both(jcfg, pcfg, p, x.at[0, 0].add(100.0), "swa", 16)
    np.testing.assert_allclose(out1[0, 8:], out2[0, 8:], atol=1e-5)
    assert not np.allclose(out1[0, 1], out2[0, 1])


def test_swa_matches_reference():
    jcfg, pcfg = cfgs(window=16, pattern=("swa",))
    p, _ = JA.attn_init(KEY, jcfg, "swa")
    x = jax.random.normal(KEY, (2, 64, jcfg.d_model))
    got = _apply_both(jcfg, pcfg, p, x, "swa", 16)
    np.testing.assert_allclose(got, np.asarray(_ref_attention(p, jcfg, x, "swa")), atol=ATOL)


def _decode_both(jcfg, pcfg, p, x, kind):
    """Token by token through both packages' decode; returns the port's
    outputs (m = 1) after checking them and the caches against the
    reference's."""
    B, S = x.shape[0], x.shape[1]
    jc = JA.make_cache(jcfg, B, S, kind=kind)
    pc = PA.make_cache(pcfg, 1, B, S, kind=kind)
    assert pc["k"].shape[1:] == jc["k"].shape
    pp, px = _node(p), _node(x)
    outs = []
    for t in range(S):
        jo, jc = JA.attn_decode(p, jcfg, x[:, t:t + 1], jc, jnp.int32(t), kind=kind)
        po, pc = PA.attn_decode(pp, pcfg, px[:, :, t:t + 1], pc, t, kind=kind)
        np.testing.assert_allclose(po[0].numpy(), np.asarray(jo), rtol=1e-4, atol=3e-5)
        assert np.array_equal(pc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
        np.testing.assert_allclose(pc["k"][0].numpy(), np.asarray(jc["k"]), **TOL)
        outs.append(po[0].numpy())
    return np.concatenate(outs, axis=1), pc


def test_decode_matches_prefill_stepwise():
    """Token-by-token decode reproduces the full forward (full attention)."""
    jcfg, pcfg = cfgs()
    p, _ = JA.attn_init(KEY, jcfg, "full")
    B, S = 2, 24
    x = jax.random.normal(KEY, (B, S, jcfg.d_model))
    want = _apply_both(jcfg, pcfg, p, x, "full", S)
    got, _ = _decode_both(jcfg, pcfg, p, x, "full")
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_decode_matches_prefill_swa_ring():
    """Ring-buffer window decode == windowed full forward."""
    jcfg, pcfg = cfgs(window=8, pattern=("swa",))
    p, _ = JA.attn_init(KEY, jcfg, "swa")
    B, S = 1, 40
    x = jax.random.normal(KEY, (B, S, jcfg.d_model))
    want = _apply_both(jcfg, pcfg, p, x, "swa", 8)
    got, cache = _decode_both(jcfg, pcfg, p, x, "swa")
    assert cache["k"].shape[2] == 8  # ring buffer = window
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_gqa_grouping_correct():
    """MHA (kv heads == heads) and GQA both run, with the reference's shapes
    and outputs."""
    jcfg, pcfg = cfgs(num_heads=4, num_kv_heads=4)
    p, _ = JA.attn_init(KEY, jcfg, "full")
    x = jax.random.normal(KEY, (1, 16, jcfg.d_model))
    out = _apply_both(jcfg, pcfg, p, x)
    _, (k, _) = PA.attn_apply(_node(p), pcfg, _node(x), torch.from_numpy(np.array(_pos(1, 16))))
    assert tuple(k.shape) == (1, 1, 16, 4, 16)
    jcfg2, pcfg2 = cfgs(num_heads=4, num_kv_heads=2)
    p2, _ = JA.attn_init(KEY, jcfg2, "full")
    out2 = _apply_both(jcfg2, pcfg2, p2, x)
    _, (k2, _) = PA.attn_apply(_node(p2), pcfg2, _node(x), torch.from_numpy(np.array(_pos(1, 16))))
    assert tuple(k2.shape) == (1, 1, 16, 2, 16) and out2.shape == out.shape


def test_attn_softcap_bounds_scores():
    jcfg, pcfg = cfgs(attn_softcap=5.0)
    q = 100.0 * jax.random.normal(KEY, (1, 8, 4, 16))
    k = 100.0 * jax.random.normal(KEY, (1, 8, 2, 16))
    want = JA._gqa_scores(q, k, jcfg)
    got = PA._gqa_scores(_node(q), _node(k), pcfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.abs().max()) <= 5.0 + 1e-5


def test_cross_attention_uses_memory():
    jcfg, pcfg = cfgs()
    p, _ = JA.attn_init(KEY, jcfg, "cross")
    x = jax.random.normal(KEY, (1, 8, jcfg.d_model))
    mem1 = jax.random.normal(jax.random.PRNGKey(1), (1, 20, jcfg.d_model))
    mem2 = jax.random.normal(jax.random.PRNGKey(2), (1, 20, jcfg.d_model))
    o1 = _apply_both(jcfg, pcfg, p, x, "cross", memory=mem1)
    o2 = _apply_both(jcfg, pcfg, p, x, "cross", memory=mem2)
    assert not np.allclose(o1, o2)
    # one-token cross decode reads the fixed memory, as the reference's
    jo, _ = JA.attn_decode(p, jcfg, x[:, :1], None, jnp.int32(0), kind="cross", memory=mem1)
    po, _ = PA.attn_decode(_node(p), pcfg, _node(x)[:, :, :1], None, 0, kind="cross", memory=_node(mem1))
    np.testing.assert_allclose(po[0].numpy(), np.asarray(jo), **TOL)
