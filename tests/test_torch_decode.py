"""The port's prefill and decode (``repro_torch.models.steps``'s prefill and
serve steps, ``repro_torch.models.transformer``'s ``init_caches``,
``cache_spec_tree`` and ``decode_step``) against the live reference.

* ``tests/test_configs_smoke.py``'s decode cases on the port, all ten
  smoke configs: a decode step from zero caches (logits' shape, finite,
  the cache tree kept), prefill then one decode step;
* parity in f32, all ten smoke configs, B = 2, S = 64, caches padded to S +
  8: ``prefill_step``'s last logits and every cache leaf (``k``, ``v``,
  ``slot_pos``, a Mamba layer's ``state`` and ``conv``), then 8
  ``serve_step``s fed the reference's greedy token: logits and the final
  caches, and the port's greedy tokens equal the reference's up to the
  first near-tie (the reference's top two logits within the largest logit
  difference of the two packages: from there the comparison of tokens
  stops, as the top-k rule does).  Bounds: the golden rtol 1e-4 with the
  model tests' atol on hidden states (2e-5; with Mamba blocks 1e-4,
  ROADMAP §C), stated in `_bounds`;
* gemma2-smoke with a prompt of 32, shorter than its window of 64: the
  reference's prefill keeps min(window, S) = 32 ring slots, so the first
  decode step at position 32 overwrites position 0's slot while the window
  still holds it; the port does the same (slot_pos and logits equal);
* ``cache_spec_tree`` is the reference's;
* one bf16 case: phi3-smoke at its bf16, prefill and 4 decode steps, logits
  within 4 bf16 steps of their scale (the repo's dense bf16 bound).

About 35 s on one worker (the reference's jitted prefill and decode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import steps as JS
from repro.models import transformer as JT
import repro_torch.configs as pconfigs
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import steps as PS
from repro_torch.models import transformer as PT

KEY = jax.random.PRNGKey(0)
B, S, GEN = 2, 64, 8
BF16_STEPS = 4 * 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs on several
    workers sharing the machine's cores, where torch's own thread pool
    (one thread a core) oversubscribes them and its small operators run
    several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cfg, S_=S, seed=0):
    """numpy prompt tokens and the modality stub."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)}
    if cfg.arch_type == "audio":
        batch["enc_embeds"] = rng.standard_normal((B, max(1, S_ // cfg.enc_seq_ratio), cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        batch["memory"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _port(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v) for k, v in batch.items()}


def _port_memory(cfg, params, batch):
    """The port's decode memory: the encoder's output (audio), the patches
    (VLM), or None."""
    if cfg.arch_type == "audio":
        with torch.no_grad():
            return PT.encoder_forward(PT.one_node(params), cfg, batch["enc_embeds"].unsqueeze(0))[0]
    return batch.get("memory")


def _memories(jc, pc, jparams, pparams, jbatch, pbatch):
    """Each package's decode memory, from its own encoder."""
    jm = JT.encoder_forward(jparams, jc, jbatch["enc_embeds"]) if jc.arch_type == "audio" else jbatch.get("memory")
    return jm, _port_memory(pc, pparams, pbatch)


def _bounds(jc) -> float:
    """The atol of logits and cache leaves: the model tests' bound on hidden
    states, 2e-5, or 1e-4 with Mamba blocks (ROADMAP §C).  Measured: up to
    5.5e-6 (logits) and 5.3e-6 (caches) on the dense and MoE configs, 1.4e-5
    and 2.0e-5 with Mamba blocks, on logits of scale 2 to 4."""
    return 1e-4 if "mamba" in jc.pattern else 2e-5


def _close(got, want, atol, what):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), rtol=1e-4, atol=atol, err_msg=what)


def _caches_close(got, want, atol, what):
    for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        if a.dtype == torch.int32:
            assert np.array_equal(a.numpy(), np.asarray(w)), what
        else:
            _close(a, w, atol, what)


# ---------------------------------------------------------------- tests/test_configs_smoke.py on the port


def _port_params(cfg):
    return PT.init_lm_params(cfg, torch.Generator().manual_seed(0))


def _stub_memory(cfg, n):
    return torch.randn((B, n, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(cfg.dtype)


@pytest.mark.parametrize("name", pconfigs.ARCH_NAMES)
def test_decode_step_smoke(name):
    cfg = pconfigs.get_config(name, smoke=True)
    params = _port_params(cfg)
    serve_step = PS.make_serve_step(cfg)
    caches = PT.init_caches(cfg, B, S, device="cpu")
    memory = {"audio": lambda: _stub_memory(cfg, 8), "vlm": lambda: _stub_memory(cfg, cfg.num_patches)}.get(
        cfg.arch_type, lambda: None)()
    logits, new_caches = serve_step(params, torch.zeros((B,), dtype=torch.int32), 0, caches, memory)
    assert logits.shape == (B, cfg.vocab_size) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert tree_map(lambda v: (tuple(v.shape), v.dtype), caches) == tree_map(lambda v: (tuple(v.shape), v.dtype),
                                                                          new_caches)


@pytest.mark.parametrize("name", pconfigs.ARCH_NAMES)
def test_prefill_then_decode_consistent(name):
    cfg = pconfigs.get_config(name, smoke=True)
    params = _port_params(cfg)
    batch = _port(_inputs(cfg), cfg.dtype)
    logits_p, caches = PS.make_prefill_step(cfg, max_len=S + 4)(params, batch)
    assert logits_p.shape == (B, cfg.vocab_size) and torch.isfinite(logits_p).all()
    memory = _port_memory(cfg, params, batch)
    logits_d, _ = PS.make_serve_step(cfg)(params, torch.ones((B,), dtype=torch.int32), S, caches, memory)
    assert logits_d.shape == (B, cfg.vocab_size) and torch.isfinite(logits_d).all()


def test_cache_spec_tree_is_the_references():
    for name in pconfigs.ARCH_NAMES:
        j, p = jconfigs.get_config(name, smoke=True), pconfigs.get_config(name, smoke=True)
        assert PT.cache_spec_tree(p) == JT.cache_spec_tree(j)


# ---------------------------------------------------------------- parity


def _serve_both(name, S_=S, gen=GEN, dtype="f32"):
    """The reference's and the port's prefill (caches padded to S_ + gen)
    and ``gen`` decode steps, each fed the reference's greedy token.
    Returns the per-step (reference, port) logits, the caches after the
    prefill and after the last step, and the greedy tokens."""
    jc, pc = jconfigs.get_config(name, smoke=True), pconfigs.get_config(name, smoke=True)
    if dtype == "f32":
        jc, pc = dataclasses.replace(jc, dtype=jnp.float32), dataclasses.replace(pc, dtype=torch.float32)
    jparams, _ = JT.init_lm_params(jc, KEY)
    pparams = from_numpy(jparams)
    inputs = _inputs(jc, S_)
    jbatch = {k: jnp.asarray(v, jc.dtype) if v.dtype == np.float32 else jnp.asarray(v) for k, v in inputs.items()}
    pbatch = _port(inputs, pc.dtype)
    jlog, jcache = jax.jit(JS.make_prefill_step(jc, max_len=S_ + gen))(jparams, jbatch)
    plog, pcache = PS.make_prefill_step(pc, max_len=S_ + gen)(pparams, pbatch)
    out = dict(jc=jc, logits=[(jlog, plog)], prefill_caches=(jcache, pcache), tokens=[])
    jmem, pmem = _memories(jc, pc, jparams, pparams, jbatch, pbatch)
    serve, pserve = jax.jit(JS.make_serve_step(jc)), PS.make_serve_step(pc)
    for i in range(gen):
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)
        out["tokens"].append((np.asarray(tok), torch.argmax(plog, -1).numpy(), np.asarray(jlog)))
        jlog, jcache = serve(jparams, tok, jnp.int32(S_ + i), jcache, jmem)
        plog, pcache = pserve(pparams, torch.from_numpy(np.array(tok)), S_ + i, pcache, pmem)
        out["logits"].append((jlog, plog))
    out["final_caches"] = (jcache, pcache)
    return out


def _greedy_up_to_a_near_tie(tokens, gap: float) -> int:
    """How many steps' greedy tokens agree before the first near-tie, where
    the reference's top two logits lie within ``gap``; fails on a parting
    that is not a near-tie."""
    for i, (jt, pt, jl) in enumerate(tokens):
        top2 = np.sort(jl, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0]) <= gap
        if np.any(tie):
            return i
        assert np.array_equal(jt, pt), f"step {i}: greedy tokens part away from a near-tie"
    return len(tokens)


@pytest.mark.parametrize("name", pconfigs.ARCH_NAMES)
def test_prefill_and_decode_match_the_reference(name):
    run = _serve_both(name)
    jc = run["jc"]
    atol = _bounds(jc)
    jcache, pcache = run["prefill_caches"]
    _caches_close(pcache, jcache, atol, f"{name} prefill caches")
    worst = 0.0
    for i, (jl, pl) in enumerate(run["logits"]):
        _close(pl, jl, atol, f"{name} logits at step {i}")
        worst = max(worst, float(np.abs(to_numpy(pl) - np.asarray(jl)).max()))
    jcache, pcache = run["final_caches"]
    _caches_close(pcache, jcache, atol, f"{name} caches after {GEN} steps")
    assert _greedy_up_to_a_near_tie(run["tokens"], 2 * worst) >= 1


def test_short_prompt_ring_overwrite_as_the_reference():
    """gemma2-smoke (window 64) with a prompt of 32: the sliding-window
    layer's prefill cache holds 32 slots, and the first decode step at
    position 32 writes slot 0, dropping position 0 while the window still
    holds it (``src/repro/models/steps.py:100-109``); the port's slots and
    logits are the reference's."""
    run = _serve_both("gemma2-27b", S_=32, gen=2)
    jc = run["jc"]
    assert jc.window == 64 and jc.pattern == ("swa", "full")
    jcache, pcache = run["prefill_caches"]
    assert pcache[0]["slot_pos"].shape == (jc.repeats, 32)
    _caches_close(pcache, jcache, _bounds(jc), "prefill caches")
    jcache, pcache = run["final_caches"]
    want = np.array([32, 33] + list(range(2, 32)), np.int32)
    for slot_pos in (pcache[0]["slot_pos"].numpy(), np.asarray(jcache[0]["slot_pos"])):
        assert (slot_pos == want).all()
    for i, (jl, pl) in enumerate(run["logits"]):
        _close(pl, jl, _bounds(jc), f"logits at step {i}")


def test_bf16_prefill_and_decode_within_bf16_steps():
    """phi3-smoke at its bf16: prefill and 4 decode steps, fed the
    reference's greedy tokens; logits within 4 bf16 steps of their scale,
    the repo's dense bf16 bound (each package rounds every bf16 product
    once, in its own summation order)."""
    run = _serve_both("phi3-mini-3.8b", gen=4, dtype="bf16")
    for i, (jl, pl) in enumerate(run["logits"]):
        jl = np.asarray(jl, np.float32)
        bound = BF16_STEPS * float(np.abs(jl).max())
        err = float(np.abs(to_numpy(pl) - jl).max())
        assert err <= bound, f"step {i}: {err} off, bound {bound}"
