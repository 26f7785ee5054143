"""The port's model layers, configs, transformer and token streams
(``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.data.synthetic``) against the live reference.

* layers: ``rms_norm``, ``apply_rope``, every ``mlp_type`` (GeGLU and GELU
  in ``jax.nn.gelu``'s tanh form), ``softcap`` and
  ``chunked_cross_entropy`` (several chunks, a mask, a logit cap), values
  and gradients on the same arrays, in f32 within rtol 1e-4 / atol 1e-6
  (the atol of a leaf's scale where that exceeds 1);
* configs: the ten archs' ``CONFIG`` and ``SMOKE`` field for field, their
  ``param_count`` and ``active_param_count``, the registry and the input
  shapes; ``init_lm_params`` gives the reference's tree structure, shapes
  and dtypes (the Mamba blocks' f32 ``a_log``, ``d_skip`` and ``dt_bias``
  and the MoE's f32 router in a bf16 model) for all ten ``SMOKE``s;
* the transformer: ``forward_hidden`` and ``lm_loss`` of all ten
  ``SMOKE``s in f32 (sliding windows, soft-caps, QKV biases, squared ReLU,
  tied and scaled embeddings, MoE, Mamba-2, the hybrid, the VLM's cross
  blocks over patches and the audio decoder over its encoder's output) on
  the reference's parameters, and the gradient of ``lm_loss`` (through
  the memory into the encoder);
* ``TokenStream`` / ``node_streams``: the reference's batches.

About 65 s on one worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.data import synthetic as jsyn
from repro.models import layers as JLy
from repro.models import transformer as JT
import repro_torch.configs as pconfigs
from repro_torch.configs.base import INPUT_SHAPES as P_SHAPES
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.data import synthetic as psyn
from repro_torch.models import layers as PLy
from repro_torch.models import transformer as PT

TOL = dict(rtol=1e-4, atol=1e-6)
KEY = jax.random.PRNGKey(0)
DENSE = [n for n in jconfigs.ARCH_NAMES if jconfigs.get_config(n).arch_type == "dense"]


def _node(tree):
    """The reference's arrays as the port's tensors with a node axis of 1."""
    return tree_map(lambda v: v.unsqueeze(0), from_numpy(tree))


def _close(got, want, what=""):
    """Leaf by leaf within rtol 1e-4 and atol 1e-6, the atol taken of the
    leaf's scale where it exceeds 1 (a gradient of a sum of squares sums
    products of order 10 into some entries near 0)."""
    for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(to_numpy(a)[0], w, rtol=TOL["rtol"], atol=atol, err_msg=what)


def _normal(shape, seed=0):
    return jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)


# ---------------------------------------------------------------- layers


def test_rms_norm_and_rope_values_and_gradients():
    x, scale = _normal((2, 8, 4, 16)), 1.0 + 0.1 * _normal((16,), 1)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32)[None], (2, 8))
    _close(PLy.rms_norm(_node(x), _node(scale)), JLy.rms_norm(x, scale))
    _close(PLy.apply_rope(_node(x), torch.from_numpy(np.array(pos)), 500.0), JLy.apply_rope(x, pos, 500.0))

    def jloss(x, s):
        return jnp.sum(JLy.apply_rope(JLy.rms_norm(x, s), pos) ** 2)

    def ploss(x, s):
        return torch.sum(PLy.apply_rope(PLy.rms_norm(x, s), torch.from_numpy(np.array(pos))) ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(x, scale)
    pg = torch.func.grad(ploss, argnums=(0, 1))(_node(x), _node(scale))
    _close(list(pg), list(jg), "gradients")


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_values_and_gradients(mlp_type):
    cfg = jconfigs.base.ModelConfig(name="t", arch_type="dense", num_layers=1, d_model=32, num_heads=2,
                                    num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=16, mlp_type=mlp_type,
                                    dtype=jnp.float32)
    p, _ = JLy.mlp_init(KEY, cfg)
    x = _normal((2, 8, 32), 3)
    _close(PLy.mlp_apply(_node(p), _node(x), mlp_type), JLy.mlp_apply(p, x, mlp_type))
    jg = jax.grad(lambda p, x: jnp.sum(JLy.mlp_apply(p, x, mlp_type) ** 2), argnums=(0, 1))(p, x)
    pg = torch.func.grad(lambda p, x: torch.sum(PLy.mlp_apply(p, x, mlp_type) ** 2), argnums=(0, 1))(_node(p), _node(x))
    _close(pg[0], jg[0], "weights")
    _close(pg[1], jg[1], "inputs")


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; erf would differ by
    up to ~1e-3 here."""
    x = jnp.linspace(-4.0, 4.0, 101)
    got = torch.nn.functional.gelu(torch.from_numpy(np.asarray(x)), approximate="tanh").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), **TOL)
    assert not np.allclose(torch.nn.functional.gelu(torch.from_numpy(np.asarray(x))).numpy(),
                           np.asarray(jax.nn.gelu(x)), atol=1e-4)


def test_softcap_and_chunked_cross_entropy():
    x = 40.0 * _normal((3, 7), 5)
    _close(PLy.softcap(_node(x), 30.0), JLy.softcap(x, 30.0))
    h, head = _normal((2, 64, 16), 6), 0.3 * _normal((16, 40), 7)
    labels = jax.random.randint(jax.random.PRNGKey(8), (2, 64), 0, 40)
    mask = (jax.random.uniform(jax.random.PRNGKey(9), (2, 64)) < 0.7).astype(jnp.float32)
    lab = torch.from_numpy(np.asarray(labels)).unsqueeze(0)
    for cap, m in ((None, None), (30.0, mask)):
        def jl(h, w):
            return JLy.chunked_cross_entropy(h, labels, w, chunk=16, logit_cap=cap, mask=m)

        def pl(h, w):
            pm = None if m is None else torch.from_numpy(np.asarray(m)).unsqueeze(0)
            return PLy.chunked_cross_entropy(h, lab, w, chunk=16, logit_cap=cap, mask=pm).sum()

        np.testing.assert_allclose(float(pl(_node(h), _node(head))), float(jl(h, head)), **TOL)
        jg = jax.grad(jl, argnums=(0, 1))(h, head)
        pg = torch.func.grad(pl, argnums=(0, 1))(_node(h), _node(head))
        _close(list(pg), list(jg), f"cap {cap}")


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_configs_and_parameter_counts_equal_the_reference(name):
    for smoke in (False, True):
        j, p = jconfigs.get_config(name, smoke=smoke), pconfigs.get_config(name, smoke=smoke)
        jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j) if f.name != "dtype"}
        pd = {f.name: getattr(p, f.name) for f in dataclasses.fields(p) if f.name != "dtype"}
        assert jd == pd and p.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert p.param_count() == j.param_count() and p.active_param_count() == j.active_param_count()
        assert p.repeats == j.repeats


def test_registry_and_input_shapes():
    assert pconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert pconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in P_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    for name in jconfigs.ARCH_NAMES:
        for shape in J_SHAPES:
            assert pconfigs.shape_applicable(pconfigs.get_config(name), P_SHAPES[shape]) == \
                jconfigs.shape_applicable(jconfigs.get_config(name), J_SHAPES[shape])
    with pytest.raises(ValueError, match="unknown arch"):
        pconfigs.get_config("gpt-5")


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_init_lm_params_has_the_reference_tree(name):
    j, p = jconfigs.get_config(name, smoke=True), pconfigs.get_config(name, smoke=True)
    want, _ = JT.init_lm_params(j, KEY)
    got = PT.init_lm_params(p, torch.Generator().manual_seed(0))
    assert jax.tree.structure(want) == jax.tree.structure(tree_map(lambda v: 0, got))
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == w.shape and a.dtype == dtypes[w.dtype.type]
    assert isinstance(got["blocks"], list) and len(got["blocks"]) == len(p.pattern)
    # the reference's tree carried across unchanged: structure, dtypes (the
    # f32 leaves of a bf16 model too) and bits
    carried = from_numpy(want)
    assert jax.tree.structure(want) == jax.tree.structure(tree_map(lambda v: 0, carried))
    for a, w in zip(tree_leaves(carried), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert a.dtype == dtypes[w.dtype.type]
        bits = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
        assert np.array_equal(bits, w.view(np.uint16) if a.dtype == torch.bfloat16 else w)


# ---------------------------------------------------------------- the transformer


def _memory(jc, params, rng, B):
    """The modality memory of an audio or vision config (None for the
    others): the encoder's output over stub frames (S / enc_seq_ratio of
    them), or stub patch embeddings."""
    if jc.arch_type == "audio":
        return rng.standard_normal((B, 32 // jc.enc_seq_ratio, jc.d_model)).astype(np.float32), True
    if jc.arch_type == "vlm":
        return rng.standard_normal((B, jc.num_patches, jc.d_model)).astype(np.float32), False
    return None, False


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_forward_and_loss_of_every_dense_smoke_in_f32(name):
    """All ten SMOKEs (the name dates from the dense slice).  The audio
    config's loss takes the encoder's output as memory and its gradient
    reaches the encoder; the VLM's takes patches.

    Hidden states within rtol 1e-4 / atol 2e-5 and gradients within atol
    2e-6, as for the dense configs; with Mamba blocks 1e-4 and 1e-5: the
    chunk scan carries every rounding of dt through exp of a cumulative
    A dt sum, and the gated norm over d_inner divides by the rms of
    y silu(z), so the input projection's reassociation differences (2.6e-6
    on entries of 4.3 in mamba2-smoke's first layer) reach 4.5e-5 in 6 of
    its 16,384 hidden entries and 4.8e-6 in 3 entries of the embedding's
    gradient (scale 1.19)."""
    jc = dataclasses.replace(jconfigs.get_config(name, smoke=True), dtype=jnp.float32)
    pc = dataclasses.replace(pconfigs.get_config(name, smoke=True), dtype=torch.float32)
    h_atol, g_atol = (1e-4, 1e-5) if "mamba" in jc.pattern else (2e-5, 2e-6)
    params, _ = JT.init_lm_params(jc, KEY)
    if jc.qkv_bias:  # nonzero biases, so their path is held too
        params = jax.tree.map(lambda v: v, params)
        for b in params["blocks"]:
            for k in ("bq", "bk", "bv"):
                b["attn"][k] = 0.1 * _normal(b["attn"][k].shape, 11)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, jc.vocab_size, (2, 32)).astype(np.int32)
    extra, encode = _memory(jc, params, rng, 2)
    pp = _node(params)
    ptok, plab = torch.from_numpy(tokens).unsqueeze(0), torch.from_numpy(labels).unsqueeze(0)
    pextra = None if extra is None else torch.from_numpy(extra).unsqueeze(0)

    def jmem(q):
        return JT.encoder_forward(q, jc, jnp.asarray(extra)) if encode else None if extra is None else jnp.asarray(extra)

    def pmem(q):
        return PT.encoder_forward(q, pc, pextra) if encode else pextra

    jh, jaux = JT.forward_hidden(params, jc, jnp.asarray(tokens), memory=jmem(params))
    ph, paux = PT.forward_hidden(pp, pc, ptok, memory=pmem(pp))
    np.testing.assert_allclose(ph[0].numpy(), np.asarray(jh), rtol=1e-4, atol=h_atol)
    np.testing.assert_allclose(float(paux[0]), float(jaux), **TOL)
    jl = JT.lm_loss(params, jc, jnp.asarray(tokens), jnp.asarray(labels), memory=jmem(params))
    np.testing.assert_allclose(float(PT.lm_loss(pp, pc, ptok, plab, memory=pmem(pp))[0]), float(jl), **TOL)
    jg = jax.grad(lambda q: JT.lm_loss(q, jc, jnp.asarray(tokens), jnp.asarray(labels), memory=jmem(q)))(params)
    pg = torch.func.grad(lambda q: PT.lm_loss(q, pc, ptok, plab, memory=pmem(q)).sum())(pp)
    for a, w in zip(tree_leaves(pg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(to_numpy(a)[0], np.asarray(w), rtol=1e-4, atol=g_atol)
    if encode:
        assert any(float(np.abs(np.asarray(w)).max()) > 0 for w in jax.tree.leaves(jg["encoder"]))


# ---------------------------------------------------------------- token streams


def test_token_streams_equal_the_reference():
    for seed in (0, 1):
        js = jsyn.node_streams(3, 96, 16, 2, seed=seed)
        ps = psyn.node_streams(3, 96, 16, 2, seed=seed)
        for _ in range(2):
            for a, b in zip(js, ps):
                ja, pb = a.next_batch(), b.next_batch()
                assert all(np.array_equal(ja[k], pb[k]) for k in ("tokens", "labels"))
