"""The audio encoder-decoder and the VLM on the port
(``repro_torch.models.transformer``): the modality memory conditions the
decoder.

* ``tests/test_modality.py``'s four cases that need no train step, on the
  port (bf16, the configs' dtype, from the reference's init): the encoder
  is bidirectional, the audio decoder conditions on the encoder, the VLM
  decoder conditions on the patches, and text layers before the first
  cross block ignore the patches.  The fifth case
  (``test_audio_train_step_uses_enc_embeds``) needs ``make_train_step``,
  which the port does not have yet.
* ``encoder_forward`` and ``forward_hidden(memory=)`` against the
  reference on seamless-smoke and llama-vision-smoke in f32, and the
  gradient of ``lm_loss`` through the memory into the encoder; within
  rtol 1e-4 and atol 2e-5 for hidden states, 2e-6 for gradients (the
  model tests' bounds).

Inputs are numpy draws from a seed.  About 20 s on one worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
from repro.models import transformer as JT
import repro_torch.configs as pconfigs
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import transformer as PT

KEY = jax.random.PRNGKey(0)
B, S = 2, 32


def _node(tree):
    return tree_map(lambda v: v.unsqueeze(0), from_numpy(tree))


def _setup(name: str, f32: bool = False):
    jc, pc = jconfigs.get_config(name, smoke=True), pconfigs.get_config(name, smoke=True)
    if f32:
        jc, pc = dataclasses.replace(jc, dtype=jnp.float32), dataclasses.replace(pc, dtype=torch.float32)
    params, _ = JT.init_lm_params(jc, KEY)
    return jc, pc, params, _node(params)


def _draw(shape, seed, dtype=torch.bfloat16):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((1, *shape)).astype(np.float32)).to(dtype)


def _tokens(vocab, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, (1, B, S)))


def _differ(a, b) -> bool:
    return not np.allclose(to_numpy(a), to_numpy(b))


def test_encoder_is_bidirectional():
    _, pc, _, pp = _setup("seamless-m4t-medium")
    x = _draw((1, 16, pc.d_model), 1)
    x2 = x.clone()
    x2[0, 0, -1] += 10.0
    out1, out2 = PT.encoder_forward(pp, pc, x), PT.encoder_forward(pp, pc, x2)
    # a LAST-frame change must affect EARLIER outputs (no causal mask)
    assert _differ(out1[0, 0, 0], out2[0, 0, 0])


def test_audio_decoder_conditions_on_encoder():
    _, pc, _, pp = _setup("seamless-m4t-medium")
    tokens = _tokens(pc.vocab_size)
    mem1 = PT.encoder_forward(pp, pc, _draw((B, 8, pc.d_model), 2))
    mem2 = PT.encoder_forward(pp, pc, _draw((B, 8, pc.d_model), 7))
    h1, _ = PT.forward_hidden(pp, pc, tokens, memory=mem1)
    h2, _ = PT.forward_hidden(pp, pc, tokens, memory=mem2)
    assert _differ(h1, h2)


def test_vlm_decoder_conditions_on_patches():
    _, pc, _, pp = _setup("llama-3.2-vision-11b")
    tokens = _tokens(pc.vocab_size)
    h1, _ = PT.forward_hidden(pp, pc, tokens, memory=_draw((B, pc.num_patches, pc.d_model), 3))
    h2, _ = PT.forward_hidden(pp, pc, tokens, memory=_draw((B, pc.num_patches, pc.d_model), 4))
    assert _differ(h1, h2)


def test_vlm_text_layers_unaffected_by_patches_before_first_cross():
    """Pattern (full x4, cross); the 2-layer smoke is (full, cross): the
    FIRST block's output must not depend on the image memory, bit for
    bit."""
    _, pc, _, pp = _setup("llama-3.2-vision-11b")
    assert pc.pattern[0] == "full" and "cross" in pc.pattern
    tokens = _tokens(pc.vocab_size)
    x = PT.embed_tokens(pp["embed"], tokens).to(pc.dtype)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    blk0 = tree_map(lambda v: v[:, 0], pp["blocks"][0])
    m1 = _draw((B, pc.num_patches, pc.d_model), 5)
    o1, _ = PT._apply_block(blk0, pc, 0, x, pos, m1)
    o2, _ = PT._apply_block(blk0, pc, 0, x, pos, m1 + 5.0)
    assert torch.equal(o1, o2)


def test_encoder_and_memory_decoder_parity_in_f32():
    """seamless-smoke: encoder_forward, forward_hidden(memory=) and the
    gradient of lm_loss with the encoder's output as memory (into every
    encoder leaf); llama-vision-smoke: forward_hidden and the gradient with
    patches as memory (into the patches too)."""
    rng = np.random.default_rng(9)
    for name, frames in (("seamless-m4t-medium", 4), ("llama-3.2-vision-11b", None)):
        jc, pc, params, pp = _setup(name, f32=True)
        tokens = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        labels = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
        ptok, plab = torch.from_numpy(tokens)[None], torch.from_numpy(labels)[None]
        extra = rng.standard_normal((B, frames or jc.num_patches, jc.d_model)).astype(np.float32)
        if frames:
            jm, pm = JT.encoder_forward(params, jc, extra), PT.encoder_forward(pp, pc, torch.from_numpy(extra)[None])
            np.testing.assert_allclose(pm[0].numpy(), np.asarray(jm), rtol=1e-4, atol=2e-5, err_msg=name)
        else:
            jm, pm = jnp.asarray(extra), torch.from_numpy(extra)[None]
        jh, _ = JT.forward_hidden(params, jc, jnp.asarray(tokens), memory=jm)
        ph, _ = PT.forward_hidden(pp, pc, ptok, memory=pm)
        np.testing.assert_allclose(ph[0].numpy(), np.asarray(jh), rtol=1e-4, atol=2e-5, err_msg=name)

        def jloss(q, e):
            mem = JT.encoder_forward(q, jc, e) if frames else e
            return JT.lm_loss(q, jc, jnp.asarray(tokens), jnp.asarray(labels), memory=mem)

        def ploss(q, e):
            mem = PT.encoder_forward(q, pc, e) if frames else e
            return PT.lm_loss(q, pc, ptok, plab, memory=mem).sum()

        jg = jax.grad(jloss, argnums=(0, 1))(params, extra)
        pg = torch.func.grad(ploss, argnums=(0, 1))(pp, torch.from_numpy(extra)[None])
        for a, w in zip(tree_leaves(list(pg)), jax.tree.leaves(list(jg))):
            np.testing.assert_allclose(to_numpy(a)[0], np.asarray(w), rtol=1e-4, atol=2e-6, err_msg=name)
        if frames:
            assert all(float(np.abs(np.asarray(w)).max()) > 0 for w in jax.tree.leaves(jg[0]["encoder"]))
