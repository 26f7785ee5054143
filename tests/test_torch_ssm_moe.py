"""The port's Mamba-2 SSD and MoE layers (``repro_torch.models.ssm``,
``repro_torch.models.moe``).

* ``tests/test_ssm_moe.py``'s eight cases on the port, with that file's own
  bounds: the chunked SSD against the sequential recurrence (3 chunkings),
  decode token by token against the chunked forward, causality, the MoE's
  shape and aux range, the dispatch against the dense top-2 mixture, and
  capacity drops.
* Parity against the reference's own functions on the same arrays, values
  and gradients, in f32 within rtol 1e-4 / atol 1e-6 (the atol of a
  leaf's scale where that exceeds 1: a gradient of a sum of squares sums
  products of order 10 to 100): ``ssd_chunked`` with 2 groups over 4
  chunks, ``_causal_conv`` with and without a decode context,
  ``mamba_apply`` with and without ``return_cache``, ``make_ssm_cache`` and
  ``mamba_decode`` token by token, ``moe_apply`` at capacity factors 0.05,
  1.25 and 4 (the same experts chosen, so the same slots dropped), the
  grouped dispatch at G = 2, a router with exactly tied logits (the lower
  expert index first, as ``jax.lax.top_k``), and the aux loss.

Inputs are numpy draws from a seed; weights are the reference's own init.
About 40 s on one worker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.configs.base import ModelConfig as PConfig
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.models import moe as PM
from repro_torch.models import ssm as PS

TOL = dict(rtol=1e-4, atol=1e-6)
KEY = jax.random.PRNGKey(0)
SSM = dict(name="t", arch_type="ssm", num_layers=2, d_model=64, num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0,
           vocab_size=64, pattern=("mamba",), ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_groups=2)
MOE = dict(name="t", arch_type="moe", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
           vocab_size=64, pattern=("full",), num_experts=4, num_experts_per_tok=2)


def _cfgs(base: dict, **kw):
    return JConfig(**base, **kw, dtype=jnp.float32), PConfig(**base, **kw, dtype=torch.float32)


def ssm_cfg(chunk=16):
    return _cfgs(SSM, ssm_chunk=chunk)[1]


def _node(tree):
    """The reference's arrays as the port's tensors with a node axis of 1."""
    return tree_map(lambda v: v.unsqueeze(0), from_numpy(tree))


def _np(tree):
    return [np.asarray(v, np.float32) for v in jax.tree.leaves(tree)]


def _close(got, want, what=""):
    """Leaf by leaf within rtol 1e-4 and atol 1e-6, the atol taken of the
    leaf's scale where it exceeds 1."""
    got = tree_leaves(got) if not isinstance(got, torch.Tensor) else [got]
    want = _np(want)
    assert len(got) == len(want), what
    for a, w in zip(got, want):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(to_numpy(a)[0], w, rtol=TOL["rtol"], atol=atol, err_msg=what)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _perturbed(params, seed):
    """The reference's init moved off its constants (ones, zeros), so the
    f32 leaves' paths are held with values of their own."""
    leaves, tree = jax.tree.flatten(params)
    return jax.tree.unflatten(tree, [v + _rand(v.shape, seed + i, 0.1) for i, v in enumerate(leaves)])


# ---------------------------------------------------------------- tests/test_ssm_moe.py on the port


def _ssd_sequential_ref(x, B_mat, C_mat, dt, a_log):
    """The O(S) recurrence (tests/test_ssm_moe.py's oracle), in numpy."""
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    A = -np.exp(a_log)
    state = np.zeros((Bsz, H, P, N))
    ys = np.zeros((Bsz, S, H, P))
    Bh, Ch = np.repeat(B_mat, H // G, axis=2), np.repeat(C_mat, H // G, axis=2)
    for t in range(S):
        da = np.exp(A * dt[:, t])
        state = state * da[:, :, None, None] + np.einsum("bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    return ys, state


def _ssd_inputs(S, H=4, P=32, G=2, N=16, Bsz=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    B_mat = (0.5 * rng.standard_normal((Bsz, S, G, N))).astype(np.float32)
    C_mat = (0.5 * rng.standard_normal((Bsz, S, G, N))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(np.float32)
    a_log = np.log(rng.uniform(1.0, 4.0, (H,))).astype(np.float32)
    return x, B_mat, C_mat, dt, a_log


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (64, 64)])
def test_ssd_chunked_matches_sequential(S, chunk):
    """The reference test's own bounds (atol 2e-3, rtol 1e-3: the recurrence
    runs in f64 and the chunked form in f32 over up to 64 steps)."""
    arrs = _ssd_inputs(S)
    y, state = PS.ssd_chunked(ssm_cfg(chunk), *[torch.from_numpy(a)[None] for a in arrs])
    y_ref, state_ref = _ssd_sequential_ref(*arrs)
    np.testing.assert_allclose(y[0].numpy(), y_ref, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(state[0].numpy(), state_ref, atol=2e-3, rtol=1e-3)


def test_mamba_decode_matches_apply():
    """Token-by-token decode equals the chunked forward (the reference
    test's bounds, atol 3e-3 / rtol 1e-2: two summation orders over 24
    steps)."""
    jc, pc = _cfgs(SSM, ssm_chunk=8)
    p = _node(JS.mamba_init(KEY, jc)[0])
    x = torch.from_numpy(_rand((2, 24, pc.d_model), 1, 0.5))[None]
    want, _ = PS.mamba_apply(p, pc, x)
    cache = PS.make_ssm_cache(pc, 1, 2, dtype=torch.float32)
    outs = []
    for t in range(24):
        o, cache = PS.mamba_decode(p, pc, x[:, :, t:t + 1], cache)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), want.numpy(), atol=3e-3, rtol=1e-2)


def test_mamba_causality():
    jc, pc = _cfgs(SSM, ssm_chunk=8)
    p = _node(JS.mamba_init(KEY, jc)[0])
    x = torch.from_numpy(_rand((1, 32, pc.d_model), 2))[None]
    y1, _ = PS.mamba_apply(p, pc, x)
    x2 = x.clone()
    x2[0, 0, -1] += 10.0
    y2, _ = PS.mamba_apply(p, pc, x2)
    np.testing.assert_allclose(y1[0, 0, :-1].numpy(), y2[0, 0, :-1].numpy(), atol=1e-4)


def test_moe_output_shape_and_aux():
    jc, pc = _cfgs(MOE)
    p = _node(JM.moe_init(KEY, jc)[0])
    x = torch.from_numpy(_rand((2, 16, pc.d_model), 3))[None]
    out, aux = PM.moe_apply(p, pc, x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    # aux in [1, E] roughly; perfectly balanced -> 1
    assert aux.shape == (1,) and 0.5 < float(aux[0]) < pc.num_experts + 1


def test_moe_matches_dense_expert_computation():
    """With generous capacity the dispatch and combine equal the direct
    per-token top-2 mixture computed densely (the reference test's bounds,
    atol 2e-4 / rtol 1e-3)."""
    jc, pc = _cfgs(MOE)
    jp = JM.moe_init(KEY, jc)[0]
    p = _node(jp)
    x = _rand((1, 8, pc.d_model), 4)
    out, _ = PM.moe_apply(p, pc, torch.from_numpy(x)[None], capacity_factor=4.0)
    xt = x.reshape(-1, pc.d_model)
    w = {k: np.asarray(v) for k, v in jp.items()}
    logits = xt @ w["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    gate = np.take_along_axis(probs, idx, -1)
    gate /= gate.sum(-1, keepdims=True)
    want = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(2):
            e = idx[t, j]
            a = xt[t] @ w["wg"][e]
            h = a / (1 + np.exp(-a)) * (xt[t] @ w["wi"][e])
            want[t] += gate[t, j] * (h @ w["wo"][e])
    np.testing.assert_allclose(out.reshape(-1, pc.d_model).numpy(), want, atol=2e-4, rtol=1e-3)


def test_moe_capacity_drops_tokens():
    """With capacity_factor -> tiny, overflow tokens contribute zeros (not
    NaNs)."""
    jc, pc = _cfgs(MOE)
    p = _node(JM.moe_init(KEY, jc)[0])
    x = torch.from_numpy(_rand((2, 32, pc.d_model), 5))[None]
    out, _ = PM.moe_apply(p, pc, x, capacity_factor=0.05)
    full, _ = PM.moe_apply(p, pc, x, capacity_factor=4.0)
    assert bool(torch.isfinite(out).all())
    assert float(torch.sum(out ** 2)) < float(torch.sum(full ** 2))


# ---------------------------------------------------------------- parity: SSM


def test_ssd_chunked_parity_values_and_gradients():
    """Two groups onto four heads (each group serves two consecutive heads,
    which a tiled repeat would get wrong), four chunks, a nonzero initial
    state; the gradients of every input (the -inf above the segment sum's
    diagonal must leave them finite)."""
    jc, pc = _cfgs(SSM, ssm_chunk=8)
    arrs = _ssd_inputs(32, seed=6)
    init = _rand((2, 4, 32, 16), 7, 0.1)

    def jl(*a):
        y, s = JS.ssd_chunked(jc, *a)
        return jnp.sum(y ** 2) + jnp.sum(s ** 2)

    def pl(*a):
        y, s = PS.ssd_chunked(pc, *a)
        return torch.sum(y ** 2) + torch.sum(s ** 2)

    jy, js = JS.ssd_chunked(jc, *arrs, init_state=init)
    py, ps = PS.ssd_chunked(pc, *_node(list(arrs)), init_state=_node(init))
    _close([py, ps], [jy, js], "values")
    jg = jax.grad(jl, argnums=(0, 1, 2, 3, 4))(*arrs)
    pg = torch.func.grad(pl, argnums=(0, 1, 2, 3, 4))(*_node(list(arrs)))
    assert all(bool(torch.isfinite(g).all()) for g in pg)
    _close(list(pg), list(jg), "gradients")


def test_causal_conv_parity():
    """The conv with zero left context and with a decode context, values and
    gradients (the taps summed in tap order)."""
    xBC, w, ctx = _rand((2, 12, 24), 8), _rand((4, 24), 9, 0.5), _rand((2, 3, 24), 10)
    _close(PS._causal_conv(*_node([xBC, w])), JS._causal_conv(xBC, w))
    _close(PS._causal_conv(*_node([xBC, w]), conv_state=_node(ctx)), JS._causal_conv(xBC, w, conv_state=ctx))
    jg = jax.grad(lambda a, b: jnp.sum(JS._causal_conv(a, b) ** 2), argnums=(0, 1))(xBC, w)
    pg = torch.func.grad(lambda a, b: torch.sum(PS._causal_conv(a, b) ** 2), argnums=(0, 1))(*_node([xBC, w]))
    _close(list(pg), list(jg), "gradients")


def test_softplus_is_jax_softplus():
    """logaddexp(x, 0), jax.nn.softplus's formula, on both sides of
    F.softplus's switch to the identity at 20: within 2^-22 relative (two
    f32 ulps: the two libraries' exp and log1p round on their own)."""
    x = np.linspace(-30.0, 30.0, 6001, dtype=np.float32)
    got = PS.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)), rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("return_cache", [False, True])
def test_mamba_apply_parity(return_cache):
    jc, pc = _cfgs(SSM, ssm_chunk=8)
    jp = _perturbed(JS.mamba_init(KEY, jc)[0], 20)
    x = _rand((2, 24, pc.d_model), 11, 0.5)
    jo, jc_out = JS.mamba_apply(jp, jc, x, return_cache=return_cache)
    po, pc_out = PS.mamba_apply(_node(jp), pc, _node(x), return_cache=return_cache)
    _close(po, jo, "out")
    _close(pc_out, jc_out, "cache" if return_cache else "state")

    def jl(p, x):
        return jnp.sum(JS.mamba_apply(p, jc, x)[0] ** 2)

    def pl(p, x):
        return torch.sum(PS.mamba_apply(p, pc, x)[0] ** 2)

    jg = jax.grad(jl, argnums=(0, 1))(jp, x)
    pg = torch.func.grad(pl, argnums=(0, 1))(_node(jp), _node(x))
    _close(pg[0], jg[0], "weights (a_log, d_skip, dt_bias f32)")
    _close(pg[1], jg[1], "inputs")


def test_mamba_decode_parity_token_by_token():
    """make_ssm_cache, then mamba_decode token by token from the prefill's
    cache: every output and both caches."""
    jc, pc = _cfgs(SSM, ssm_chunk=8)
    jp = _perturbed(JS.mamba_init(KEY, jc)[0], 30)
    pp = _node(jp)
    jcache, pcache = JS.make_ssm_cache(jc, 2, dtype=jnp.float32), PS.make_ssm_cache(pc, 1, 2, dtype=torch.float32)
    assert [tuple(v.shape[1:]) for v in tree_leaves(pcache)] == [v.shape for v in jax.tree.leaves(jcache)]
    x = _rand((2, 16, pc.d_model), 12, 0.5)
    _, jcache = JS.mamba_apply(jp, jc, x[:, :8], return_cache=True)
    _, pcache = PS.mamba_apply(pp, pc, _node(x[:, :8]), return_cache=True)
    for t in range(8, 16):
        jo, jcache = JS.mamba_decode(jp, jc, x[:, t:t + 1], jcache)
        po, pcache = PS.mamba_decode(pp, pc, _node(x[:, t:t + 1]), pcache)
        _close(po, jo, f"token {t}")
        _close(pcache, jcache, f"cache after token {t}")


# ---------------------------------------------------------------- parity: MoE


def _moe_pair(p, jc, pc, x, cf):
    jo, ja = JM.moe_apply(p, jc, x, cf)
    po, pa = PM.moe_apply(_node(p), pc, _node(x), cf)
    return (jo, ja), (po, pa)


def _experts(p, jc, pc, x):
    """Each package's top-k experts of x's tokens."""
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    want = np.asarray(jax.lax.top_k(probs, jc.num_experts_per_tok)[1])
    got = PM._route(_node(p), pc, _node(xt))[1][0].numpy()
    return got, want


@pytest.mark.parametrize("cf", [0.05, 1.25, 4.0])
def test_moe_apply_parity(cf):
    """Values, the aux loss and the gradients of every weight (the f32
    router too) and of x.  The experts chosen are equal, so the slots
    dropped at capacity are the same (token-major positions of the same
    choices); at 0.05 the capacity is the floor of 8 a expert and slots are
    dropped."""
    jc, pc = _cfgs(MOE)
    p = JM.moe_init(KEY, jc)[0]
    x = _rand((2, 32, pc.d_model), 13)
    got, want = _experts(p, jc, pc, x)
    assert np.array_equal(got, want)
    counts = np.bincount(want.reshape(-1), minlength=pc.num_experts)
    C = max(8, int(64 * 2 / 4 * cf))
    if cf != 1.25:
        assert (counts > C).any() == (cf == 0.05), (counts, C)
    (jo, ja), (po, pa) = _moe_pair(p, jc, pc, x, cf)
    _close(po, jo, "out")
    np.testing.assert_allclose(float(pa[0]), float(ja), **TOL)

    def jl(p, x):
        out, aux = JM.moe_apply(p, jc, x, cf)
        return jnp.sum(out ** 2) + aux

    def pl(p, x):
        out, aux = PM.moe_apply(p, pc, x, cf)
        return torch.sum(out ** 2) + aux.sum()

    jg = jax.grad(jl, argnums=(0, 1))(p, x)
    pg = torch.func.grad(pl, argnums=(0, 1))(_node(p), _node(x))
    _close(pg[0], jg[0], "weights")
    _close(pg[1], jg[1], "inputs")


@pytest.mark.parametrize("cf", [0.05, 1.25])
def test_moe_grouped_dispatch_parity(cf):
    """set_moe_dispatch_groups(2) in both packages: each group its own
    capacity and the grouped aux scaling; reset to 1 afterwards."""
    jc, pc = _cfgs(MOE)
    p = JM.moe_init(KEY, jc)[0]
    x = _rand((2, 32, pc.d_model), 14)
    try:
        JM.set_moe_dispatch_groups(2)
        PM.set_moe_dispatch_groups(2)
        (jo, ja), (po, pa) = _moe_pair(p, jc, pc, x, cf)
        _close(po, jo, "out")
        np.testing.assert_allclose(float(pa[0]), float(ja), **TOL)
        jg = jax.grad(lambda p: jnp.sum(JM.moe_apply(p, jc, x, cf)[0] ** 2))(p)
        pg = torch.func.grad(lambda q: torch.sum(PM.moe_apply(q, pc, _node(x), cf)[0] ** 2))(_node(p))
        _close(pg, jg, "weights")
    finally:
        JM.set_moe_dispatch_groups(1)
        PM.set_moe_dispatch_groups(1)
    assert JM._DISPATCH_GROUPS == PM._DISPATCH_GROUPS == 1


def test_moe_router_ties_go_to_the_lower_expert_index():
    """A router with identical columns for experts 0 and 2 and for 1 and 3
    gives exactly tied probabilities; ``jax.lax.top_k`` puts the lower index
    first and so must the port: the same experts, the same gates, the same
    dropped slots (capacity 8 binds), the same output."""
    jc, pc = _cfgs(MOE)
    p = dict(JM.moe_init(KEY, jc)[0])
    r = np.asarray(p["router"])
    p["router"] = jnp.asarray(np.stack([r[:, 0], r[:, 1], r[:, 0], r[:, 1]], axis=1))
    x = _rand((2, 32, pc.d_model), 15)
    got, want = _experts(p, jc, pc, x)
    assert np.array_equal(got, want) and all(tuple(r) in ((0, 2), (1, 3)) for r in want)
    for cf in (0.05, 4.0):
        (jo, ja), (po, pa) = _moe_pair(p, jc, pc, x, cf)
        _close(po, jo, f"out at {cf}")
        np.testing.assert_allclose(float(pa[0]), float(ja), **TOL)


def test_moe_aux_loss_parity_and_per_node():
    """The aux loss (E sum_e f_e p_e) per node: two nodes with their own
    weights and tokens give each node's reference loss."""
    jc, pc = _cfgs(MOE)
    ps = [JM.moe_init(jax.random.PRNGKey(k), jc)[0] for k in (1, 2)]
    xs = [_rand((2, 16, pc.d_model), 16 + k) for k in (1, 2)]
    stacked = tree_map(lambda *v: torch.stack(v), *[from_numpy(p) for p in ps])
    out, aux = PM.moe_apply(stacked, pc, torch.from_numpy(np.stack(xs)))
    for i, (p, x) in enumerate(zip(ps, xs)):
        jo, ja = JM.moe_apply(p, jc, x)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(float(aux[i]), float(ja), **TOL)
