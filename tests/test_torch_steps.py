"""The port's train step and step-factory plumbing
(``repro_torch.models.steps.make_train_step``, ``repro_torch.configs.
input_specs``, the stacked initialization) against the live reference.

* ``tests/test_configs_smoke.py``'s cases on the port, for all ten smoke
  configs: a train step (finite loss, every run moves the parameters), the
  analytic parameter count against a concrete init, the full configs'
  exact dims and model-scale counts, ``input_specs`` over every input shape
  (meta tensors, caches present for decode).  Its decode cases are in
  ``tests/test_torch_decode.py``; ``test_abstract_params_match_concrete``
  waits for the launch-planning slice;
* ``tests/test_modality.py::test_audio_train_step_uses_enc_embeds`` on the
  port;
* parity of ``train_step`` in f32 on dense (phi3), SWA with soft-caps
  (gemma2), MoE (mixtral), SSM (mamba2), hybrid (jamba), audio (seamless)
  and VLM (llama-3.2-vision) smoke configs, B = 2, S = 64, from the
  reference's parameters and batch: one SGD-M step and one AdamW step,
  each against the reference's (one jit per config holds both): loss and
  ``grad_norm`` within the golden tolerance (rtol 1e-4, atol 1e-6); the
  clipped gradient (SGD-M's first momentum) within the model tests'
  gradient bound (atol 2e-6, with Mamba blocks 1e-5: ROADMAP §C); the
  parameters within the golden tolerance plus what that gradient bound
  moves them (lr times it for SGD-M; for AdamW, whose first step is g /
  (|g| + eps), nearly sign(g), lr times min(2, 2 bound / |g|): up to 2 lr
  where g lies within the bound of zero); the moments likewise;
* the stacked initialization fills each (R, ...) leaf repeat by repeat and
  equals ``torch.stack`` of the repeats bit for bit (all ten configs);
* the train step recomputes each checkpointed repeat once in its backward
  pass under plain autograd.

About 55 s on one worker (the reference's jitted steps)."""

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
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import steps as PS
from repro_torch.models import transformer as PT

TOL = dict(rtol=1e-4, atol=1e-6)
KEY = jax.random.PRNGKey(0)
B, S = 2, 64
FAMILIES = ["phi3-mini-3.8b", "gemma2-27b", "mixtral-8x7b", "mamba2-2.7b", "jamba-1.5-large-398b",
            "seamless-m4t-medium", "llama-3.2-vision-11b"]
LR = {"sgd": 1e-2, "adamw": 1e-3}


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


def _batch(cfg, seed=0, labels=True):
    """numpy tokens, labels and the modality stub of a (B, S) batch."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tok}
    if labels:
        batch["labels"] = np.roll(tok, -1, axis=1)
    if cfg.arch_type == "audio":
        batch["enc_embeds"] = rng.standard_normal((B, max(1, S // cfg.enc_seq_ratio), cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        batch["memory"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _port_batch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v) for k, v in batch.items()}


def _port_params(cfg, seed=0):
    return PT.init_lm_params(cfg, torch.Generator().manual_seed(seed))


def _clone(tree):
    return tree_map(torch.clone, tree)


# ---------------------------------------------------------------- tests/test_configs_smoke.py on the port


@pytest.mark.parametrize("name", pconfigs.ARCH_NAMES)
def test_train_step_smoke(name):
    cfg = pconfigs.get_config(name, smoke=True)
    params = _port_params(cfg)
    before = _clone(params)
    train_step, opt = PS.make_train_step(cfg, "adamw", lr=1e-3)
    opt_state = opt.init(params)
    params2, opt_state2, metrics = train_step(params, opt_state, _port_batch(_batch(cfg), cfg.dtype))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0 and np.isfinite(float(metrics["grad_norm"]))
    assert opt_state2.step == 1
    delta = sum(float((a.float() - b.float()).abs().sum()) for a, b in zip(tree_leaves(before), tree_leaves(params2)))
    assert delta > 0  # the parameters moved (in place: params2 is params)


@pytest.mark.parametrize("name", pconfigs.ARCH_NAMES)
def test_param_count_analytic_close(name):
    """ModelConfig.param_count() tracks a concrete init."""
    cfg = pconfigs.get_config(name, smoke=True)
    actual = sum(v.numel() for v in tree_leaves(_port_params(cfg)))
    assert abs(actual - cfg.param_count()) / actual < 0.02, (actual, cfg.param_count())


def test_full_config_exact_dims():
    """The FULL configs carry the exact assigned dimensions (no allocation)."""
    expect = {
        "mamba2-2.7b": dict(num_layers=64, d_model=2560, d_ff=0, vocab_size=50280, ssm_state=128),
        "phi3-mini-3.8b": dict(num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064),
        "mixtral-8x7b": dict(num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
                             num_experts=8),
        "nemotron-4-15b": dict(num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, d_ff=24576,
                               vocab_size=256000),
        "jamba-1.5-large-398b": dict(num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
                                     vocab_size=65536, num_experts=16),
        "seamless-m4t-medium": dict(num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
                                    vocab_size=256206),
        "llama-3.2-vision-11b": dict(num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
                                     vocab_size=128256),
        "qwen2-7b": dict(num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064),
        "gemma2-27b": dict(num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, d_ff=36864, vocab_size=256000),
        "mixtral-8x22b": dict(num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, d_ff=16384,
                              vocab_size=32768, num_experts=8),
    }
    for name, dims in expect.items():
        cfg = pconfigs.get_config(name)
        for k, v in dims.items():
            assert getattr(cfg, k) == v, (name, k, getattr(cfg, k), v)


def test_param_counts_match_model_scale():
    approx = {"mamba2-2.7b": 2.7e9, "phi3-mini-3.8b": 3.8e9, "mixtral-8x7b": 47e9, "nemotron-4-15b": 15e9,
              "jamba-1.5-large-398b": 398e9, "qwen2-7b": 7.6e9, "gemma2-27b": 27e9, "mixtral-8x22b": 141e9}
    for name, target in approx.items():
        n = pconfigs.get_config(name).param_count()
        assert 0.55 * target < n < 1.7 * target, (name, n, target)


def test_input_specs_cover_all_shapes():
    """Meta tensors (no allocation) for every input of every step; decode
    carries the caches, shaped as init_caches and as the reference's
    specs (leaf by leaf: shape and dtype)."""
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32, jnp.int32: torch.int32}
    for name in pconfigs.ARCH_NAMES:
        pc, jc = pconfigs.get_config(name, smoke=True), jconfigs.get_config(name, smoke=True)
        for shape in INPUT_SHAPES.values():
            small = InputShape(shape.name, 256, 2, shape.kind)
            specs = pconfigs.input_specs(pc, small)
            leaves = tree_leaves(specs)
            assert all(isinstance(x, torch.Tensor) and x.device.type == "meta" for x in leaves)
            if shape.kind == "decode":
                assert "caches" in specs
            want = jconfigs.input_specs(jc, jconfigs.base.InputShape(shape.name, 256, 2, shape.kind))
            assert jax.tree.structure(want) == jax.tree.structure(tree_map(lambda v: 0, specs))
            for a, w in zip(leaves, jax.tree.leaves(want)):
                assert tuple(a.shape) == w.shape and a.dtype == dtypes[w.dtype.type], (name, shape.name)


def test_audio_train_step_uses_enc_embeds():
    """tests/test_modality.py's case: the encoder's input reaches the loss
    (each step from a fresh copy: the port's step updates in place)."""
    cfg = pconfigs.get_config("seamless-m4t-medium", smoke=True)
    params = _port_params(cfg)
    step, opt = PS.make_train_step(cfg, "sgd", lr=1e-2)
    base = _port_batch(_batch(cfg), cfg.dtype)
    base["enc_embeds"] = torch.from_numpy(
        np.random.default_rng(1).standard_normal((B, 8, cfg.d_model)).astype(np.float32)).to(cfg.dtype)
    p1 = _clone(params)
    _, _, m1 = step(p1, opt.init(p1), base)
    base2 = dict(base, enc_embeds=base["enc_embeds"] + 3.0)
    p2 = _clone(params)
    _, _, m2 = step(p2, opt.init(p2), base2)
    assert float(m1["loss"]) != float(m2["loss"])


# ---------------------------------------------------------------- parity


def _ref_steps(jc):
    """One jit holding the reference's SGD-M and AdamW train steps from the
    same parameters and batch."""
    sgd, sopt = JS.make_train_step(jc, "sgd", lr=LR["sgd"])
    adam, aopt = JS.make_train_step(jc, "adamw", lr=LR["adamw"])
    both = jax.jit(lambda p, s1, s2, b: (sgd(p, s1, b), adam(p, s2, b)))
    return both, sopt, aopt


def _leaf_check(got, want, bound, what):
    got, want = to_numpy(got), np.asarray(want, np.float32)
    err = np.abs(got - want)
    ok = err <= TOL["atol"] + TOL["rtol"] * np.abs(want) + bound
    assert ok.all(), f"{what}: {int((~ok).sum())} entries off, worst {float((err - bound).max())}"


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_the_reference(name):
    jc = dataclasses.replace(jconfigs.get_config(name, smoke=True), dtype=jnp.float32)
    pc = dataclasses.replace(pconfigs.get_config(name, smoke=True), dtype=torch.float32)
    g_atol = 1e-5 if "mamba" in jc.pattern else 2e-6  # the model tests' gradient bound (ROADMAP §C)
    params, _ = JT.init_lm_params(jc, KEY)
    batch = _batch(jc)
    both, sopt, aopt = _ref_steps(jc)
    (jp_s, js_s, jm_s), (jp_a, js_a, jm_a) = both(params, sopt.init(params), aopt.init(params),
                                                  jax.tree.map(jnp.asarray, batch))
    g = jax.tree.leaves(js_s.m)  # SGD-M's first momentum: the clipped gradient
    for algo, jp, js, jm in (("sgd", jp_s, js_s, jm_s), ("adamw", jp_a, js_a, jm_a)):
        pp = from_numpy(params)
        step, opt = PS.make_train_step(pc, algo, lr=LR[algo])
        pp, ps, pm = step(pp, opt.init(pp), _port_batch(batch, torch.float32))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), **TOL, err_msg=f"{algo} {k}")
        lr = LR[algo]
        for a, w, gl, mg, mw in zip(tree_leaves(pp), jax.tree.leaves(jp), g, tree_leaves(ps.m), jax.tree.leaves(js.m)):
            gl = np.abs(np.asarray(gl))
            if algo == "sgd":
                _leaf_check(mg, mw, g_atol, f"{name} sgd momentum")
                _leaf_check(a, w, lr * g_atol, f"{name} sgd parameters")
            else:
                _leaf_check(mg, mw, (1 - 0.9) * g_atol, f"{name} adamw m")
                _leaf_check(a, w, lr * np.minimum(2.0, 2.0 * g_atol / np.maximum(gl, 1e-30)), f"{name} adamw params")
        if algo == "adamw":
            for mv, wv, gl in zip(tree_leaves(ps.v), jax.tree.leaves(js.v), g):
                gl = np.abs(np.asarray(gl))
                _leaf_check(mv, wv, (1 - 0.95) * (2 * gl * g_atol + g_atol ** 2), f"{name} adamw v")
        assert ps.step == int(js.step) == 1


# ---------------------------------------------------------------- the stacked init and the recompute


@pytest.mark.parametrize("name", pconfigs.ARCH_NAMES)
def test_stacked_init_equals_stacking_the_repeats(name, monkeypatch):
    """The preallocated (R, ...) leaves, filled repeat by repeat, equal
    torch.stack of every repeat's draw, bit for bit, drawn in the same
    order (the blocks' and the encoder's)."""
    cfg = pconfigs.get_config(name, smoke=True)
    new = _port_params(cfg, seed=3)
    def stacking(draw, n):  # every repeat's (tree, axes) drawn, then torch.stack
        draws = [draw() for _ in range(n)]
        return tree_map(lambda *vs: torch.stack(vs), *[t for t, _ in draws]), draws[0][1]

    monkeypatch.setattr(PT, "_stacked", stacking)
    old = _port_params(cfg, seed=3)
    for a, b in zip(tree_leaves(new), tree_leaves(old)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def test_train_step_recomputes_each_repeat_once(monkeypatch):
    """Under plain autograd the checkpointed repeat and encoder block run
    once forward and once in the backward pass."""
    cfg = pconfigs.get_config("seamless-m4t-medium", smoke=True)
    calls = {"repeat": 0, "enc": 0}
    repeat, enc = PT._repeat, PT._enc_block

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(PT, "_repeat", count("repeat", repeat))
    monkeypatch.setattr(PT, "_enc_block", count("enc", enc))
    params = _port_params(cfg)
    step, opt = PS.make_train_step(cfg, "sgd", lr=1e-2)
    step(params, opt.init(params), _port_batch(_batch(cfg), cfg.dtype))
    assert calls == {"repeat": 2 * cfg.repeats, "enc": 2 * cfg.enc_layers}
