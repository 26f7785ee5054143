"""The dense LM bilevel run (``repro_torch.core.lm_bilevel``) against the
live JAX reference, in process.

The reference's LM transport test (tests/test_lm_transport.py:132-137)
runs ``lm-test`` (one dense block, d_model 64, 4 heads over 2 kv heads,
SwiGLU, vocab 128; m = 8 nodes on a ring, B = 2, S = 32, T = 2, block
top-k at 0.1 in blocks of 512, K = 2, lam = 10) on 8 forced host devices
in a subprocess; here both packages run it in this process, from the
reference's own ``init_node_params`` arrays and the same token streams.

* **f32, round by round**: each round runs in both packages on the
  reference's round-t state, the port keeping the coordinates the
  reference's top-k kept (`repro_torch.core.selection`: a row whose own
  choice parts must be a near-tie).  x, y, z and every float metric agree
  within rtol 1e-4 / atol 1e-6; s_x and u, where u = gfx + lam (ggx_y -
  ggx_z) multiplies the x-partials' rounding by up to 1 + 2 lam, within
  rtol 1e-4 / atol (1 + 2 lam) 1e-6; ``measured_bytes`` and the oracle
  counts are equal.
* **compute_flops / hbm_bytes** of ``run(obs=)``: each oracle's count (an
  x-partial of f or g with its forward, a y-gradient, a y-gradient of h,
  the three x-partials together) equals the reference's XLA count.  The
  round's differs: the port computes each x-only value once a round, and
  the reference's round counts one more y-gradient of g with its
  backbone forward (ROADMAP §C); the port's count is pinned to the closed
  form of its products (`_port_round_flops`).
* **bf16** (the configs' dtype), round by round as f32, within a bound
  stated below from bf16's 2^-8 step; ``measured_bytes`` may differ by
  survivors that one package rounds to exactly zero.
* **the fused exchange**: ``DeviceTransport(fused=True)`` bit for bit the
  dense exchange, each node's executed bytes the port's
  ``measure_tree_bytes_chunked`` of the dense slices, leaves kept bf16.
* the reference's C2DFB-reduces-validation-loss case
  (tests/test_lm_bilevel.py), in both packages.
* the recompute (`repro_torch.models.remat`): gradients equal the plain
  ones bit for bit, and its products are in ``round_cost``.

The MoE, SSM and hybrid configs of lm-test's size (A10b) are held the
same way in tests/test_torch_lm_bilevel_archs.py: each compiles the
reference's init state and round in XLA, so they are a file of their own,
spread over the workers.  This file: about 200 s on one worker."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import c2dfb as J
from repro.core import inner_loop as jinner
from repro.core import lm_bilevel as JL
from repro.core import topology as jtopo
from repro.core.types import node_mean as jnode_mean
from repro.launch.hlo_cost import analyze
from repro.obs import MemorySink as JSink
from repro_torch.configs.base import ModelConfig as PConfig
from repro_torch.core import c2dfb as P
from repro_torch.core import lm_bilevel as PL
from repro_torch.core import selection
from repro_torch.core import topology as ptopo
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.types import node_mean, tree_leaves, tree_map
from repro_torch.data.synthetic import node_streams
from repro_torch.models import remat
from repro_torch.net.wire import measure_tree_bytes_chunked
from repro_torch.obs import MemorySink
from repro_torch.obs.compute import round_cost
from repro_torch.transport import DeviceTransport, run_c2dfb_transport

RTOL, ATOL = 1e-4, 1e-6
LM = dict(name="lm-test", arch_type="dense", pattern=("full",), mlp_type="swiglu", num_layers=1, d_model=64,
          num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
M, B, S, T, CHUNK = 8, 2, 32, 2, 4096
RUN = dict(lam=10.0, eta_out=0.02, gamma_out=0.5, eta_in=0.06, gamma_in=0.5, K=2, compressor="block_topk",
           comp_ratio=0.1, comp_block=512)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the bf16 bound: a bf16 value carries 2^-8 of relative precision, and the
# two packages round each product and sum on their own; a round moves
# every leaf through K inner steps and the mixes, so the round-t states may
# part by a few bf16 steps of the leaf's largest magnitude: 4 * 2^-8 of it
BF16_STEPS = 4 * 2.0 ** -8


# MoE, SSM and hybrid configs of lm-test's size (A10b): mixtral's sliding
# window and top-2 of 4 experts; mamba2's SSD with 2 groups over 4 heads and
# 2 chunks of S = 32; jamba's (mamba, full) pattern without RoPE, its MoE on
# the second position
MOE_TEST = dict(name="moe-test", arch_type="moe", pattern=("swa",), window=16, mlp_type="swiglu", num_layers=1,
                d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128, num_experts=4,
                num_experts_per_tok=2)
SSM_TEST = dict(name="ssm-test", arch_type="ssm", pattern=("mamba",), num_layers=1, d_model=64, num_heads=0,
                num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=128, ssm_state=16, ssm_heads=4, ssm_head_dim=32,
                ssm_groups=2, ssm_chunk=16)
HYBRID_TEST = dict(SSM_TEST, name="hybrid-test", arch_type="hybrid", pattern=("mamba", "full"), num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, use_rope=False, num_experts=4,
                   num_experts_per_tok=2, moe_period=2, moe_offset=1)
ARCHS = {"moe": MOE_TEST, "ssm": SSM_TEST, "hybrid": HYBRID_TEST}


def _data(seed: int) -> dict:
    bs = [s.next_batch() for s in node_streams(M, LM["vocab_size"], S, B, seed=seed)]
    return {k: np.stack([b[k] for b in bs]) for k in ("tokens", "labels")}


@dataclasses.dataclass
class Pair:
    jcfg: object
    pcfg: object
    jp: object  # the reference's problem
    pp: object  # the port's
    x0: object  # the reference's node-stacked arrays
    y0: object


def _pair(dt: str, arch: dict = LM, **over) -> Pair:
    jdt, pdt = DTYPES[dt]
    jcfg, pcfg = JConfig(**arch, dtype=jdt, **over), PConfig(**arch, dtype=pdt, **over)
    tr, va = _data(0), _data(1)
    jp = JL.make_lm_bilevel(jcfg, tree_map_np(jnp.asarray, tr), tree_map_np(jnp.asarray, va), M)
    pp = PL.make_lm_bilevel(pcfg, from_numpy(tr), from_numpy(va), M)
    x0, y0 = JL.init_node_params(jcfg, jax.random.PRNGKey(0), M)
    return Pair(jcfg, pcfg, jp, pp, x0, y0)


def tree_map_np(fn, d: dict) -> dict:
    return {k: fn(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def f32():
    return _pair("f32")


@pytest.fixture(scope="module")
def bf16():
    return _pair("bf16")


def _record_reference_rounds(pair: Pair, monkeypatch, run_kw=RUN, rounds=T) -> list:
    """The reference's rounds from its init state, stepped with its jitted
    ``c2dfb_round``: per round the input state, the output state and
    metrics, and for each compression (inner steps in order, d then s,
    leaves in order) its residual and the mask of the coordinates its top-k
    kept, read out of the jitted body by debug callbacks."""
    steps = []
    apply = jinner.inner_apply

    def recording_apply(st, *args):
        st2, (q_d, q_s) = apply(st, *args)
        resid = [a - b for tv, tr in ((st2.d, st.d_hat), (st2.s, st.s_hat))
                 for a, b in zip(jax.tree.leaves(tv), jax.tree.leaves(tr))]
        qs = jax.tree.leaves(q_d) + jax.tree.leaves(q_s)
        jax.debug.callback(lambda *a: steps.append([(np.asarray(r), np.asarray(q) != 0) for r, q in
                                                    zip(a[:len(resid)], a[len(resid):])]), *resid, *qs, ordered=True)
        return st2, (q_d, q_s)

    monkeypatch.setattr(jinner, "inner_apply", recording_apply)
    cfg, topo = J.C2DFBConfig(**run_kw), jtopo.ring(M)
    step = jax.jit(lambda s, k: J.c2dfb_round(s, k, pair.jp, topo, cfg))
    # the init state jitted, as the round: op by op it takes 20-30 s on a
    # Mamba config; either way both packages step from the reference's state
    state = jax.jit(lambda x, y: J.init_state(pair.jp, cfg, x, y))(pair.x0, pair.y0)
    out = []
    for t in range(rounds):
        nxt, mets = step(state, jax.random.PRNGKey(t))
        jax.effects_barrier()
        out.append(dict(state=state, out=nxt, mets=mets, comps=[c for s in steps for c in s]))
        steps.clear()
        state = nxt
    monkeypatch.setattr(jinner, "inner_apply", apply)
    return out


def _selection_log(comps, compressor, pdt) -> list:
    """The reference's compressions as a `selection.recorded` log of the
    port's rows (residuals carried at their dtype)."""
    log = []
    for resid, kept in comps:
        r = from_numpy(resid).to(pdt)
        log.append((selection._rows(compressor, r), selection._rows(compressor, torch.from_numpy(kept).float()) != 0))
    return log


def _state_fields(s):
    return dict(x=s.x, s_x=s.s_x, u=s.u_prev, y=s.inner_y.d, y_hat=s.inner_y.d_hat, y_s=s.inner_y.s,
                y_g=s.inner_y.g_prev, z=s.inner_z.d, z_hat=s.inner_z.d_hat, z_s=s.inner_z.s, z_g=s.inner_z.g_prev)


def _leaves_np(tree):
    return [np.asarray(v, np.float32) for v in (jax.tree.leaves(tree) if not _is_port(tree) else
                                                 [to_numpy(v) for v in tree_leaves(tree)])]


def _is_port(tree) -> bool:
    return isinstance(tree_leaves(tree)[0], torch.Tensor)


def _round_by_round(pair: Pair, rounds: list, monkeypatch, pdt) -> list:
    """The port's c2dfb_round on each recorded round's input state, keeping
    the reference's selections; returns per round (port output, metrics,
    selection partings)."""
    cfg = P.C2DFBConfig(**RUN)
    comp = cfg.make_compressor()
    out = []
    for r in rounds:
        seen = selection.Partings()
        with selection.imposed(_selection_log(r["comps"], comp, pdt), seen):
            ps, pm = P.c2dfb_round(from_numpy(r["state"]), None, pair.pp, ptopo.ring(M), cfg)
        assert seen.compressions == 4 * cfg.K * len(tree_leaves(ps.inner_y.d))
        out.append((ps, pm, seen))
    return out


def test_split_merge_roundtrip():
    """The port's split keeps the head as y and the backbone as x, and
    merges back, on the reference's parameter tree carried across."""
    from repro.models.transformer import init_lm_params

    params = from_numpy(init_lm_params(JConfig(**LM), jax.random.PRNGKey(0))[0])
    x, y = PL.split_params(params)
    assert set(y) == {"final_norm", "lm_head"} and set(x) == {"embed", "blocks"}
    assert isinstance(x["blocks"], list)
    assert set(PL.merge_params(x, y)) == set(params)


def _f32_rounds_equal(pair: Pair, monkeypatch, rounds: int = T, atol: float = ATOL) -> None:
    recorded = _record_reference_rounds(pair, monkeypatch, rounds=rounds)
    lam = RUN["lam"]
    for t, (r, (ps, pm, seen)) in enumerate(zip(recorded, _round_by_round(pair, recorded, monkeypatch,
                                                                          torch.float32))):
        want = _state_fields(r["out"])
        for name, got in _state_fields(ps).items():
            tol = (1 + 2 * lam) * atol if name in ("s_x", "u") else atol
            for a, w in zip(_leaves_np(got), _leaves_np(want[name])):
                np.testing.assert_allclose(a, w, rtol=RTOL, atol=tol, err_msg=f"round {t} {name}")
        for k, v in pm.items():
            if k == "measured_bytes":
                assert int(v) == int(r["mets"][k]), (t, k)
            else:
                np.testing.assert_allclose(v.numpy(), np.asarray(r["mets"][k]), rtol=RTOL, atol=atol,
                                           err_msg=f"round {t} {k}")
        assert seen.rows <= 2, f"round {t}: {seen.rows} rows parted (each a near-tie)"


def test_f32_rounds_equal_the_reference_round_by_round(f32, monkeypatch):
    _f32_rounds_equal(f32, monkeypatch)


def _bf16_rounds_within_the_bound(pair: Pair, monkeypatch, rounds: int = T, steps: float = BF16_STEPS) -> None:
    recorded = _record_reference_rounds(pair, monkeypatch, rounds=rounds)
    lam = RUN["lam"]
    worst = 0.0
    for t, (r, (ps, pm, seen)) in enumerate(zip(recorded, _round_by_round(pair, recorded, monkeypatch,
                                                                          torch.bfloat16))):
        want = _state_fields(r["out"])
        for name, got in _state_fields(ps).items():
            factor = 1 + 2 * lam if name in ("s_x", "u") else 1
            # a tracker sums gradients: its rounding is of their magnitude
            of = {"y_s": "y_g", "z_s": "z_g"}.get(name, name)
            for a, w, g in zip(_leaves_np(got), _leaves_np(want[name]), _leaves_np(want[of])):
                bound = factor * steps * max(float(np.abs(w).max()), float(np.abs(g).max()))
                worst = max(worst, float(np.abs(a - w).max()) / bound)
                assert float(np.abs(a - w).max()) <= bound, (t, name, float(np.abs(a - w).max()), bound)
        # every leaf keeps the reference's dtype (bf16, and a Mamba block's
        # f32 a_log, d_skip and dt_bias, a MoE's f32 router)
        for got, want_tree in ((ps.x, r["out"].x), (ps.inner_y.d, r["out"].inner_y.d)):
            assert [str(v.dtype) for v in tree_leaves(got)] == \
                ["torch." + str(np.dtype(w.dtype)) for w in jax.tree.leaves(want_tree)]
        # every survivor is 8 bytes and the headers are the same; a kept
        # coordinate whose residual one package rounds to exactly zero is
        # not sent, which bf16's 2^-8 step allows for at most that share of
        # the survivors
        got, want_b = int(pm["measured_bytes"]), int(r["mets"]["measured_bytes"])
        assert (got - want_b) % 8 == 0 and abs(got - want_b) / 8 <= 2.0 ** -8 * want_b / 8, (t, got, want_b)
    print(f"worst {worst:.3f} of the bound")


def test_bf16_rounds_within_the_bound_round_by_round(bf16, monkeypatch):
    """bf16 leaves (the configs' dtype), round by round on the reference's
    states with its selections: every leaf of every field within
    ``BF16_STEPS`` of the leaf's largest magnitude (of a tracker's, or of
    the gradients it sums if larger), times 1 + 2 lam for s_x and u (as
    the f32 atol); measured bytes within 2^-8 of the survivors; the leaves
    stay bf16."""
    _bf16_rounds_within_the_bound(bf16, monkeypatch)


# ---------------------------------------------------------------- compute meter


def _port_round_flops(cfg, run_kw, m, B, S, n_x, n_y) -> int:
    """The port's C2DFB round on the LM split, in FLOPs of its matrix
    products (all m nodes), for the one-chunk case (S <= the query chunk
    and the cross-entropy chunk).  Per node, with N = B S tokens:

    * fwd: one data set's backbone forward (q, k, v, o; scores and
      weighted values; the MLP), computed once a round for each of the
      two data sets (it reads x alone);
    * head: one product of the LM head, 2 N d V;
    * a y-gradient of one data set's loss: the head's recompute, its
      weight gradient and the hidden states' gradient, 3 head; the y loop
      takes K + 1 of h's (both data sets), the z loop K + 1 of g's;
    * an x-partial: the head's recompute and the hidden states' gradient
      (2 head) and the backbone's backward (2 fwd), plus the backbone's
      recompute (fwd less the last MLP output product, which the backward
      never reads) once a data set: the x-partials of g at y and at z
      share it;
    * the mixes: W (m x m) times every node's copy, 2 m n a tree of n
      entries a node: 2 outer (x, s_x) and 2 K a loop (d_hat, s_hat)."""
    d, H, KV, hd, f, V = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    N, K, R = B * S, run_kw["K"], cfg.num_layers
    attn = 2 * N * d * (H + 2 * KV) * hd + 2 * N * H * hd * d + 2 * (2 * B * H * S * S * hd)
    mlp = 3 * 2 * N * d * f
    fwd = R * (attn + mlp)
    head = 2 * N * d * V
    recompute = fwd - 2 * N * f * d
    per_node = (2 * fwd + (K + 1) * 9 * head + 3 * (2 * head + 2 * fwd) + 2 * recompute
                + 2 * m * (2 * n_x + 2 * 2 * K * n_y))
    return m * per_node


def _reference_cost(fn, *args) -> dict:
    return analyze(jax.jit(fn).lower(*args).compile().as_text())


def _oracle_costs(pair: Pair) -> dict:
    """Each oracle's (port, reference) counts: (FLOPs, dot bytes), its x-only
    forward included, the port's by ``round_cost`` and the reference's by
    XLA's compiled HLO."""
    jp, pp = pair.jp, pair.pp
    x, y = from_numpy(pair.x0), from_numpy(pair.y0)
    lam = RUN["lam"]
    cases = {
        "x-partial of g": (lambda a, b: jax.vmap(jax.grad(jp.g, argnums=0))(a, b, jp.data_g),
                           lambda: pp.graphs.grad("g", pp._g, x, y, 0)),
        "y-gradient of g": (lambda a, b: jax.vmap(jax.grad(jp.g, argnums=1))(a, b, jp.data_g),
                            lambda: pp.grad_y_g()(y, x)),
        "y-gradient of h": (lambda a, b: jax.vmap(jax.grad(lambda u, v, df, dg: jp.f(u, v, df) + lam * jp.g(u, v, dg),
                                                           argnums=1))(a, b, jp.data_f, jp.data_g),
                            lambda: pp.grad_y_h(lam)(y, x)),
        "hypergradient": (lambda a, b, c: (jax.vmap(jax.grad(jp.f, argnums=0))(a, b, jp.data_f),
                                           jax.vmap(jax.grad(jp.g, argnums=0))(a, b, jp.data_g),
                                           jax.vmap(jax.grad(jp.g, argnums=0))(a, c, jp.data_g)),
                          lambda: pp.hyper_grad(x, y, tree_map(torch.clone, y), lam)),
    }
    out = {}
    for name, (jfn, pfn) in cases.items():
        # z is an argument of its own, as in the round, where it differs from y
        want = _reference_cost(jfn, pair.x0, pair.y0, pair.y0) if name == "hypergradient" else \
            _reference_cost(jfn, pair.x0, pair.y0)
        pp.graphs.forget()
        _, got = round_cost(pfn)
        out[name] = ((got.flops, got.hbm_bytes), (want["flops"], want["dot_bytes"]))
    return out


def test_oracle_costs_equal_the_reference(f32):
    """Each oracle's FLOPs and dot bytes, its x-only forward included,
    equal the reference's XLA counts."""
    for name, (got, want) in _oracle_costs(f32).items():
        assert got == want, name


def test_run_counts_bytes_oracles_and_the_round_cost(f32):
    """run(obs=) in both packages, T = 2: ``measured_bytes`` and the oracle
    calls equal; the port's compute_flops is the closed form of its
    products; the reference's exceeds it by one y-gradient of g with its
    backbone forward (ROADMAP §C), and its hbm_bytes by the pinned gap."""
    js, ps = JSink(), MemorySink()
    _, jm = J.run(f32.jp, jtopo.ring(M), J.C2DFBConfig(**RUN), f32.x0, f32.y0, T=T, key=jax.random.PRNGKey(0), obs=js)
    _, pm = P.run(f32.pp, ptopo.ring(M), P.C2DFBConfig(**RUN), from_numpy(f32.x0), from_numpy(f32.y0), T=T,
                  device="cpu", obs=ps)
    assert [int(v) for v in pm["measured_bytes"]] == [int(v) for v in np.asarray(jm["measured_bytes"])]
    jr, pr = js.rows(kind="round"), ps.rows(kind="round")
    assert [r["oracle_calls"] for r in pr] == [r["oracle_calls"] for r in jr]
    x0 = from_numpy(f32.x0)
    n_x = sum(v[0].numel() for v in tree_leaves(x0))
    n_y = sum(v[0].numel() for v in tree_leaves(from_numpy(f32.y0)))
    assert pr[0]["compute_flops"] == _port_round_flops(f32.pcfg, RUN, M, B, S, n_x, n_y)
    jp = f32.jp
    extra = _reference_cost(lambda a, b: jax.vmap(jax.grad(jp.g, argnums=1))(a, b, jp.data_g), f32.x0, f32.y0)
    assert jr[0]["compute_flops"] == pr[0]["compute_flops"] + extra["flops"]
    assert jr[0]["hbm_bytes"] - pr[0]["hbm_bytes"] == HBM_GAP


# the reference's round counts 6,553,600 more dot bytes than the port's at
# lm-test in f32: one y-gradient of g with its forward is 6,160,384 of
# them, and the rest is 49,152 a node (ROADMAP §C)
HBM_GAP = 6_553_600


# ---------------------------------------------------------------- the fused exchange


def test_fused_exchange_is_the_dense_one_bit_for_bit(bf16):
    """lm-test in bf16 through run(transport=DeviceTransport(fused=True))
    and the dense exchange, T = 2: every state tensor and metric bit for
    bit; each node's executed bytes on every step equal
    measure_tree_bytes_chunked of the dense slices; the leaves stay bf16."""
    cfg = P.C2DFBConfig(**RUN)
    x0, y0 = from_numpy(bf16.x0), from_numpy(bf16.y0)
    runs = {}
    for fused in (True, False):
        runs[fused] = run_c2dfb_transport(bf16.pp, ptopo.ring(M), cfg, x0, y0, T, None,
                                          DeviceTransport(fused=fused, chunk=CHUNK), device="cpu", return_payloads=True)
    (sf, mf), (sd, md) = runs[True], runs[False]
    from repro_torch.async_gossip.compiled import _tensors

    for a, b in zip(_tensors(sf), _tensors(sd)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                                  b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    for k in ("hypergrad_norm", "measured_bytes", "wire_bytes", "x_consensus_err", "y_consensus_err"):
        assert np.array_equal(mf[k], md[k]), k
    assert all(v.dtype == torch.bfloat16 for v in tree_leaves(sf.x) + tree_leaves(sf.inner_y.d))
    comp = cfg.make_compressor()
    for t in range(T):
        nb_f, pl_d = mf["payloads"][t]["node_bytes"], md["payloads"][t]
        for tag in ("y", "z"):
            for k in range(cfg.K):
                for name, stack in zip(("d", "s"), pl_d[tag]):
                    for i in range(M):
                        slc = [torch.from_numpy(np.asarray(v[k, i])) for v in tree_leaves(stack)]
                        assert nb_f[f"{tag}/in{k}/{name}"][i] == measure_tree_bytes_chunked(comp, slc, CHUNK)


# ---------------------------------------------------------------- the paper's LM case


def test_c2dfb_reduces_lm_val_loss_in_both_packages():
    """tests/test_lm_bilevel.py's case (2 blocks of d_model 96, m = 3, B =
    2, S = 64, K = 5, top-k 0.2, 4 rounds, bf16): the validation loss at
    the consensus mean falls in both packages from the same start, and
    the port's x keeps bf16; the two final losses agree within the bf16
    bound of their scale."""
    kw = dict(name="t", arch_type="dense", pattern=("full",), mlp_type="swiglu", num_layers=2, d_model=96,
              num_heads=4, num_kv_heads=2, head_dim=24, d_ff=192, vocab_size=256)
    m = 3
    run_kw = dict(lam=10.0, eta_out=0.02, gamma_out=0.5, eta_in=0.06, gamma_in=0.5, K=5, compressor="topk",
                  comp_ratio=0.2)

    def data(seed):
        bs = [s.next_batch() for s in node_streams(m, 256, 64, 2, seed=seed)]
        return {k: np.stack([b[k] for b in bs]) for k in ("tokens", "labels")}

    tr, va = data(0), data(1)
    jcfg = JConfig(**kw)
    jp = JL.make_lm_bilevel(jcfg, tree_map_np(jnp.asarray, tr), tree_map_np(jnp.asarray, va), m)
    pp = PL.make_lm_bilevel(PConfig(**kw), from_numpy(tr), from_numpy(va), m)
    x0, y0 = JL.init_node_params(jcfg, jax.random.PRNGKey(0), m)
    js, _ = J.run(jp, jtopo.ring(m), J.C2DFBConfig(**run_kw), x0, y0, T=4, key=jax.random.PRNGKey(0))
    ps, pm = P.run(pp, ptopo.ring(m), P.C2DFBConfig(**run_kw), from_numpy(x0), from_numpy(y0), T=4, device="cpu")
    j0 = float(jp.mean_f(jnode_mean(x0), jnode_mean(y0)))
    j1 = float(jp.mean_f(jnode_mean(js.x), jnode_mean(js.inner_y.d)))
    p0 = float(pp.mean_f(node_mean(from_numpy(x0)), node_mean(from_numpy(y0))))
    p1 = float(pp.mean_f(node_mean(ps.x), node_mean(ps.inner_y.d)))
    assert np.isfinite(p1) and p1 < p0 and j1 < j0, (p0, p1, j0, j1)
    assert abs(p0 - j0) <= BF16_STEPS * j0 and abs(p1 - j1) <= BF16_STEPS * j1, (p0, j0, p1, j1)
    assert float(pm["x_consensus_err"][-1]) < 10.0
    assert all(v.dtype == torch.bfloat16 for v in tree_leaves(ps.x))


# ---------------------------------------------------------------- the recompute


def test_recompute_gives_the_plain_gradient_and_is_counted(f32):
    """With the blocks' recompute (the configs' default) and without it
    (``remat_policy="none"``: only the attention and cross-entropy chunks
    recompute), the traced x-partial is the same bit for bit; with it,
    round_cost counts the blocks' recompute."""
    x, y = from_numpy(f32.x0), from_numpy(f32.y0)
    plain = PL.make_lm_bilevel(dataclasses.replace(f32.pcfg, remat_policy="none"), f32.pp.data_g, f32.pp.data_f, M)
    f32.pp.graphs.forget()
    got, cg = round_cost(lambda: f32.pp.graphs.grad("g", f32.pp._g, x, y, 0))
    want, cw = round_cost(lambda: plain.graphs.grad("g", plain._g, x, y, 0))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    cfg = f32.pcfg
    N = B * S
    attn = (2 * N * cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
            + 2 * N * cfg.num_heads * cfg.head_dim * cfg.d_model + 4 * B * cfg.num_heads * S * S * cfg.head_dim)
    fwd = attn + 6 * N * cfg.d_model * cfg.d_ff
    # the blocks' recompute, less its last MLP product (never read) and less
    # the scores the attention chunk's own recompute took without it
    scores = 2 * B * cfg.num_heads * S * S * cfg.head_dim
    assert cg.flops - cw.flops == M * (fwd - 2 * N * cfg.d_ff * cfg.d_model - scores)
    assert remat._RECOMPUTING == [0]
