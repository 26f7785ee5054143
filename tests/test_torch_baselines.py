"""The port's baselines (MDBO, MADSBO, C2DFB-nc, F2SA) against a LIVE run
of the JAX reference on the small coefficient-tuning task, from the same
numpy start: second-order oracles, rounds, wire bytes and oracle counts.

Floats agree within the golden tolerance (rtol 1e-4, atol 1e-6: BLAS
reassociation, and double backward where the reference goes forward over
reverse); wire bytes and oracle counts are equal exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import topology as jtopo
from repro.core.c2dfb import C2DFBConfig as JC2DFBConfig
from repro.data import bilevel_tasks as jtasks
from repro.obs.compute import c2dfb_oracle_calls, madsbo_oracle_calls, mdbo_oracle_calls
from repro_torch.core import baselines as PB
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.c2dfb import C2DFBConfig
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.data import bilevel_tasks as ptasks

from _torch_replay import JaxReplay, record_quant_margins, round_leaf_keys

RTOL, ATOL = 1e-4, 1e-6
M = 4
TASKS = {
    "coef": (jtasks.coefficient_tuning_task, ptasks.coefficient_tuning_task,
             dict(m=M, n=200, p=64, c=4, seed=0)),
    "hyper": (jtasks.hyper_representation_task, ptasks.hyper_representation_task,
              dict(m=M, n=200, side=5, hidden=6, c=3, h=0.5, seed=2)),
}
MDBO = dict(K=3, neumann_N=3)
MADSBO = dict(K=3, Q=3)
F2SA = dict(K=3)
ROUNDS = 2


@pytest.fixture(scope="module", params=sorted(TASKS))
def task(request):
    jb_fn, pb_fn, kw = TASKS[request.param]
    return jb_fn(**kw), pb_fn(**kw, device="cpu")


@pytest.fixture(scope="module")
def coef():
    jb_fn, pb_fn, kw = TASKS["coef"]
    return jb_fn(**kw), pb_fn(**kw, device="cpu")


def _close(got, want, what):
    g = ptypes.tree_leaves(to_numpy(got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


def _metrics_close(pm, jm):
    assert set(pm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)


def test_second_order_oracles_match_reference(task):
    jb, pb = task
    rng = np.random.default_rng(3)
    jx, jy = jb.x0, jb.y0
    jv = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jy)
    jy = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.normal(size=a.shape), a.dtype), jy)
    px, py, pv = from_numpy(jx), from_numpy(jy), from_numpy(jv)
    g, dg = jb.problem.g, jb.problem.data_g
    want_h = jax.vmap(lambda xi, yi, vi, d: JB._hvp_yy(g, xi, yi, vi, d))(jx, jy, jv, dg)
    want_j = jax.vmap(lambda xi, yi, vi, d: JB._jvp_xy(g, xi, yi, vi, d))(jx, jy, jv, dg)
    pb.problem.oracle_calls.clear()
    _close(PB._hvp_yy(pb.problem, px, py, pv), want_h, "hvp_yy")
    _close(PB._jvp_xy(pb.problem, px, py, pv), want_j, "jvp_xy")
    assert pb.problem.oracle_calls == {"hvp": 1, "jvp": 1}


def test_mdbo_rounds_match_reference(task):
    jb, pb = task
    jcfg, pcfg = JB.MDBOConfig(**MDBO), PB.MDBOConfig(**MDBO)
    js, ps = JB.mdbo_init(jb.x0, jb.y0), PB.mdbo_init(from_numpy(jb.x0), from_numpy(jb.y0))
    for _ in range(ROUNDS):
        js, jm = JB.mdbo_round(js, jb.problem, jtopo.ring(M), jcfg)
        pb.problem.oracle_calls.clear()
        ps, pm = PB.mdbo_round(ps, pb.problem, ptopo.ring(M), pcfg)
        _metrics_close(pm, jm)
    _close(ps.x, js.x, "x")
    _close(ps.y, js.y, "y")
    assert ps.t == int(js.t) == ROUNDS
    assert pb.problem.oracle_calls == mdbo_oracle_calls(pcfg)
    assert PB.mdbo_round_wire_bytes(ps, pcfg, ptopo.ring(M)) == JB.mdbo_round_wire_bytes(js, jcfg, jtopo.ring(M))


def test_madsbo_rounds_match_reference(task):
    jb, pb = task
    jcfg, pcfg = JB.MADSBOConfig(**MADSBO), PB.MADSBOConfig(**MADSBO)
    js = JB.madsbo_init(jb.problem, jb.x0, jb.y0)
    ps = PB.madsbo_init(pb.problem, from_numpy(jb.x0), from_numpy(jb.y0))
    _close(ps.u, js.u, "u0")
    for _ in range(ROUNDS):
        js, jm = JB.madsbo_round(js, jb.problem, jtopo.ring(M), jcfg)
        pb.problem.oracle_calls.clear()
        ps, pm = PB.madsbo_round(ps, pb.problem, ptopo.ring(M), pcfg)
        _metrics_close(pm, jm)
    for f in ("x", "y", "v", "u"):
        _close(getattr(ps, f), getattr(js, f), f)
    assert pb.problem.oracle_calls == madsbo_oracle_calls(pcfg)
    assert PB.madsbo_round_wire_bytes(ps, pcfg, ptopo.ring(M)) == JB.madsbo_round_wire_bytes(
        js, jcfg, jtopo.ring(M)
    )


def test_madsbo_from_a_carried_reference_state(coef):
    """One round from the reference's mid-run state, carried by from_numpy."""
    jb, pb = coef
    jcfg, pcfg = JB.MADSBOConfig(**MADSBO), PB.MADSBOConfig(**MADSBO)
    mid, _ = JB.madsbo_round(JB.madsbo_init(jb.problem, jb.x0, jb.y0), jb.problem, jtopo.ring(M), jcfg)
    js, jm = JB.madsbo_round(mid, jb.problem, jtopo.ring(M), jcfg)
    carried = from_numpy(mid)
    assert type(carried) is PB.MADSBOState and carried.t == 1
    ps, pm = PB.madsbo_round(carried, pb.problem, ptopo.ring(M), pcfg)
    _metrics_close(pm, jm)
    _close(ps.v, js.v, "v")


NC_CASES = {
    "kernel_topk": dict(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128),
    # key 3: see test_c2dfb_nc_rounds_match_reference for the margin
    "kernel_quant": dict(K=3, compressor="kernel_quant", comp_bits=4, comp_block=128),
}
NC_KEY = 3


@pytest.mark.parametrize("case", sorted(NC_CASES))
def test_c2dfb_nc_rounds_match_reference(case, coef, monkeypatch):
    """C2DFB-nc compresses Q(value + error).  With kernel_quant it draws the
    reference's own samples; quantization is discontinuous, so the key is
    one where no sample lies within 1e-5 of its rounding threshold."""
    jb, pb = coef
    jcfg, pcfg = JC2DFBConfig(**NC_CASES[case]), C2DFBConfig(**NC_CASES[case])
    margins = record_quant_margins(monkeypatch)
    js = JB.c2dfb_nc_init(jb.problem, jcfg, jb.x0, jb.y0)
    ps = PB.c2dfb_nc_init(pb.problem, pcfg, from_numpy(jb.x0), from_numpy(jb.y0))
    for key in jax.random.split(jax.random.PRNGKey(NC_KEY), ROUNDS):
        js, jm = JB.c2dfb_nc_round(js, key, jb.problem, jtopo.ring(M), jcfg)
        replay = JaxReplay(round_leaf_keys(key, pcfg.K, 1), M)
        pb.problem.oracle_calls.clear()
        ps, pm = PB.c2dfb_nc_round(ps, replay, pb.problem, ptopo.ring(M), pcfg)
        _metrics_close(pm, jm)
        assert replay.draws == (4 * pcfg.K if case == "kernel_quant" else 0)
    for f in ("x", "s_x"):
        _close(getattr(ps, f), getattr(js, f), f)
    for f in ("d", "e_d", "s", "e_s"):
        _close(getattr(ps.inner_y, f), getattr(js.inner_y, f), f"y.{f}")
        _close(getattr(ps.inner_z, f), getattr(js.inner_z, f), f"z.{f}")
    assert pb.problem.oracle_calls == {k: v for k, v in c2dfb_oracle_calls(pcfg).items() if v}
    if case == "kernel_quant":
        assert len(margins) == 4 * pcfg.K * ROUNDS
        assert min(margins) > 1e-5, f"a sample lies {min(margins)} from its threshold"


def test_c2dfb_nc_stochastic_compressor_needs_a_source(coef):
    _, pb = coef
    cfg = C2DFBConfig(**NC_CASES["kernel_quant"])
    state = PB.c2dfb_nc_init(pb.problem, cfg, pb.x0, pb.y0)
    with pytest.raises(ValueError, match="KernelQuant"):
        PB.c2dfb_nc_round(state, None, pb.problem, ptopo.ring(M), cfg)


def test_f2sa_rounds_match_reference(task):
    jb, pb = task
    jcfg, pcfg = JB.F2SAConfig(**F2SA), PB.F2SAConfig(**F2SA)
    jx0 = jax.tree.map(lambda v: jnp.mean(v, axis=0), jb.x0)
    jy0 = jax.tree.map(lambda v: jnp.mean(v, axis=0), jb.y0)
    js, ps = JB.f2sa_init(jx0, jy0), PB.f2sa_init(from_numpy(jx0), from_numpy(jy0))
    for _ in range(ROUNDS):
        js, jm = JB.f2sa_round(js, jb.problem, jcfg)
        pb.problem.oracle_calls.clear()
        ps, pm = PB.f2sa_round(ps, pb.problem, pcfg)
        _metrics_close(pm, jm)
    for f in ("x", "y", "z"):
        _close(getattr(ps, f), getattr(js, f), f)
    # the reference meters no F2SA site; its code takes K gradients of the
    # pooled h and K of the pooled g (lower level), then one gradient of
    # psi_lam in x: the x-partials of f at y, g at y and g at z
    assert pb.problem.oracle_calls == {"ll_grad": 2 * pcfg.K, "ul_grad": 3}
