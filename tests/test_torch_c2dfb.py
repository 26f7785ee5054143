"""Synchronous C2DFB in the port against a LIVE run of the JAX reference
(never against tests/golden/*.npz, whose y0 draw drifts with jax's threefry
setting): the golden-sync configuration, kernel_topk with real selection,
hyper-representation, and one round from a carried mid-run state.

Floats agree within the golden tolerance (rtol 1e-4, atol 1e-6: BLAS
reassociation); wire bytes and oracle counts are equal exactly."""

import jax
import numpy as np
import pytest
import torch

from repro.core import c2dfb as J
from repro.core import topology as jtopo
from repro.data import bilevel_tasks as jtasks
from repro.obs.compute import c2dfb_oracle_calls
from repro_torch.core import c2dfb as P
from repro_torch.core import topology as ptopo
from repro_torch.core import types as ptypes
from repro_torch.core.convert import from_numpy, to_numpy
from repro_torch.data import bilevel_tasks as ptasks

RTOL, ATOL = 1e-4, 1e-6

CASES = {
    # tests/test_golden_trajectories.py's sync configuration
    "golden_sync": (
        "coef", dict(m=4, n=80, p=12, c=3, h=0.5, seed=0),
        dict(K=3, compressor="topk", comp_ratio=0.3, gamma_in=0.3, eta_in=0.3),
    ),
    # 256 values a node in two blocks of 128, k = 26 < nnz: real selection
    "kernel_topk": (
        "coef", dict(m=4, n=200, p=64, c=4, seed=0),
        dict(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128),
    ),
    "hyper_rep": (
        "hyper", dict(m=4, n=200, side=6, hidden=8, c=4, h=0.5, seed=0),
        dict(K=3, compressor="topk", comp_ratio=0.3),
    ),
}
BUILDERS = {
    "coef": (jtasks.coefficient_tuning_task, ptasks.coefficient_tuning_task),
    "hyper": (jtasks.hyper_representation_task, ptasks.hyper_representation_task),
}
T = 3


def _assert_tree_close(got, want, what):
    g = ptypes.tree_leaves(to_numpy(got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_states_close(ps, js):
    _assert_tree_close(ps.x, js.x, "x")
    _assert_tree_close(ps.s_x, js.s_x, "s_x")
    _assert_tree_close(ps.inner_y.d, js.inner_y.d, "y")
    _assert_tree_close(ps.inner_z.d, js.inner_z.d, "z")
    assert ps.t == int(js.t)


def _assert_metrics_match(pm, jm):
    assert set(pm) == set(jm)
    for k, v in jm.items():
        if k == "measured_bytes":
            np.testing.assert_array_equal(pm[k].cpu().numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(pm[k].cpu().numpy(), np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    task, task_kw, cfg_kw = CASES[request.param]
    jbuild, pbuild = BUILDERS[task]
    jb, pb = jbuild(**task_kw), pbuild(**task_kw, device="cpu")
    jcfg, pcfg = J.C2DFBConfig(**cfg_kw), P.C2DFBConfig(**cfg_kw)
    m = task_kw["m"]
    js, jm = J.run(jb.problem, jtopo.ring(m), jcfg, jb.x0, jb.y0, T=T, key=jax.random.PRNGKey(0))
    x0, y0 = from_numpy(jb.x0), from_numpy(jb.y0)
    x0_copy = ptypes.tree_map(torch.clone, x0)
    ps, pm = P.run(pb.problem, ptopo.ring(m), pcfg, x0, y0, T=T, device="cpu")
    return dict(
        name=request.param, jb=jb, pb=pb, jcfg=jcfg, pcfg=pcfg, m=m, js=js, jm=jm,
        ps=ps, pm=pm, x0=x0, x0_copy=x0_copy,
    )


def test_trajectory_matches_reference(case):
    _assert_states_close(case["ps"], case["js"])
    _assert_metrics_match(case["pm"], case["jm"])
    for a, b in zip(ptypes.tree_leaves(case["x0"]), ptypes.tree_leaves(case["x0_copy"])):
        assert torch.equal(a, b)  # the caller's x0 survives the run


def test_round_wire_bytes_equal_reference(case):
    m = case["m"]
    jw = J.round_wire_bytes_measured(case["js"], case["jcfg"], jtopo.ring(m), jax.random.PRNGKey(1))
    pw = P.round_wire_bytes_measured(case["ps"], case["pcfg"], ptopo.ring(m))
    assert pw == jw
    assert P.round_wire_bytes(case["ps"], case["pcfg"], ptopo.ring(m)) == J.round_wire_bytes(
        case["js"], case["jcfg"], jtopo.ring(m)
    )


def test_oracle_counts_per_round(case):
    pb, pcfg = case["pb"], case["pcfg"]
    state = from_numpy(case["js"], "cpu")
    pb.problem.oracle_calls.clear()
    P.c2dfb_round(state, None, pb.problem, ptopo.ring(case["m"]), pcfg)
    want = {k: v for k, v in c2dfb_oracle_calls(pcfg).items() if v}
    assert pb.problem.oracle_calls == want == {"ul_grad": 3, "ll_grad": 2 * (pcfg.K + 1)}


def test_kernel_topk_really_selects():
    """In the kernel_topk case the residuals hold more than k nonzeros a
    block, so the bisection kernel's selection shapes the trajectory."""
    task, task_kw, cfg_kw = CASES["kernel_topk"]
    pb = ptasks.coefficient_tuning_task(**task_kw, device="cpu")
    cfg = P.C2DFBConfig(**cfg_kw)
    state = P.init_state(pb.problem, cfg, pb.x0, pb.y0)
    state, _ = P.c2dfb_round(state, None, pb.problem, ptopo.ring(task_kw["m"]), cfg)
    resid = (state.inner_y.s - state.inner_y.s_hat).reshape(task_kw["m"], -1, cfg.comp_block)
    k = round(cfg.comp_ratio * cfg.comp_block)
    assert (torch.count_nonzero(resid, dim=-1) > k).any()


def test_one_round_from_a_carried_mid_run_state():
    task, task_kw, cfg_kw = CASES["kernel_topk"]
    jb = jtasks.coefficient_tuning_task(**task_kw)
    pb = ptasks.coefficient_tuning_task(**task_kw, device="cpu")
    jcfg, pcfg = J.C2DFBConfig(**cfg_kw), P.C2DFBConfig(**cfg_kw)
    m = task_kw["m"]
    mid, _ = J.run(jb.problem, jtopo.ring(m), jcfg, jb.x0, jb.y0, T=2, key=jax.random.PRNGKey(0))
    js, jm = J.c2dfb_round(mid, jax.random.PRNGKey(5), jb.problem, jtopo.ring(m), jcfg)
    ps, pm = P.c2dfb_round(from_numpy(mid, "cpu"), None, pb.problem, ptopo.ring(m), pcfg)
    _assert_states_close(ps, js)
    _assert_metrics_match(pm, jm)
    _assert_tree_close(ps.inner_y.d_hat, js.inner_y.d_hat, "y_hat")
    _assert_tree_close(ps.inner_z.s_hat, js.inner_z.s_hat, "z tracker ref")
