"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
reference's, and the ``"dots"`` recompute policy.

* every smoke case on a fake 8-rank (data 2, model 4) mesh, B = 8, S =
  64: phi3, mixtral, mamba2 and seamless x train, prefill and decode,
  ``status == "ok"``, and each one's argument and output bytes per device
  equal to the reference's local-shard sums under its in- and
  out-shardings (computed by the reference's own ``build_case`` in a
  subprocess with 8 forced host devices), the arguments those its step
  reads, as jit keeps them (a Mamba stack's decode reads no position, an
  audio decoder's no encoder);
* per-device FLOPs within [global / chips, global] of a FlopCounterMode
  count of the unsharded step (on meta tensors); collectives issued on the
  2 x 4 mesh, none on a 1 x 1 mesh;
* ``model_flops`` equal to the reference's for the ten archs x four
  shapes, and ``roofline_terms`` equal to the reference's formula with
  the H100 constants in place of the TPU's;
* the CLI writes a record a case;
* ``"dots"`` against ``"nothing"`` on a phi3-smoke train step: the same
  gradient bit for bit, and the backward's recompute FLOPs fewer by
  exactly the saved products' (the one-model linears of every repeat).

About 40 s on one worker."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, InputShape, get_config, input_specs
from repro_torch.core.types import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM
from repro_torch.launch import roofline as PR
from repro_torch.models import steps as PS
from repro_torch.models.transformer import abstract_lm_params

ARCHS = ["phi3-mini-3.8b", "mixtral-8x7b", "mamba2-2.7b", "seamless-m4t-medium"]
KINDS = ["train_4k", "prefill_32k", "decode_32k"]
CASES = [f"{a}/{k}" for a in ARCHS for k in KINDS]
B, S = 8, 64

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import json, sys
import jax
import numpy as np
assert len(jax.devices()) == 8
from repro.configs import get_config
from repro.configs.base import InputShape
import repro.launch.dryrun as D

spec = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
D.get_config = lambda a: get_config(a, smoke=True)
for k in spec["kinds"]:
    s = D.INPUT_SHAPES[k]
    D.INPUT_SHAPES[k] = InputShape(k, spec["S"], spec["B"], s.kind)
isl = lambda x: isinstance(x, jax.sharding.NamedSharding)


def local(tree, sh, keep=None):
    per = jax.tree.leaves(jax.tree.map(lambda s, sub: jax.tree.map(lambda _: s, sub), sh, tree, is_leaf=isl),
                          is_leaf=isl)
    sizes = [int(np.prod(s.shard_shape(l.shape))) * np.dtype(l.dtype).itemsize
             for s, l in zip(per, jax.tree.leaves(tree))]
    return int(sum(n for i, n in enumerate(sizes) if keep is None or keep[i]))


def read(fn, args):
    # whether the step reads each flattened argument: jit prunes the others from the compiled step's
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    used = {id(v) for e in jaxpr.eqns for v in e.invars} | {id(v) for v in jaxpr.outvars}
    return [id(v) in used for v in jaxpr.invars]


out = {}
for arch in spec["archs"]:
    for k in spec["kinds"]:
        fn, args, in_sh, out_sh, cfg, shape = D.build_case(arch, k, mesh)
        out[f"{arch}/{k}"] = {"arg": local(args, in_sh, read(fn, args)),
                              "out": local(jax.eval_shape(fn, *args), out_sh)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    spec = dict(archs=ARCHS, kinds=KINDS, B=B, S=S)
    res = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(spec)], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _shape(kind: str) -> InputShape:
    return InputShape(kind, S, B, INPUT_SHAPES[kind].kind)


@pytest.fixture(scope="module")
def records():
    """The port's dry run of every case, on the 2 x 4 fake mesh and on a
    1 x 1 one."""
    out = {}
    mesh = PM.make_fake_mesh((2, 4), ("data", "model"), "cpu")
    for case in CASES:
        arch, kind = case.split("/")
        out[case] = D.dryrun_one(arch, _shape(kind), False, device="cpu", mesh=mesh, smoke=True)
    one = PM.make_fake_mesh((1, 1), ("data", "model"), "cpu")
    for kind in KINDS:
        out[f"1x1/{kind}"] = D.dryrun_one("phi3-mini-3.8b", _shape(kind), False, device="cpu", mesh=one, smoke=True)
    yield out
    PM.release()


@pytest.mark.parametrize("case", CASES)
def test_smoke_cases_run(records, case):
    rec = records[case]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    mem = rec["memory_analysis"]
    assert mem["peak_size_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0


@pytest.mark.parametrize("case", CASES)
def test_argument_and_output_bytes_equal_the_reference(reference, records, case):
    mem = records[case]["memory_analysis"]
    assert mem["argument_size_in_bytes"] == reference[case]["arg"]
    assert mem["output_size_in_bytes"] == reference[case]["out"]


def _unsharded_flops(arch: str, kind: str) -> int:
    """FlopCounterMode's count of the step on meta tensors, one device."""
    cfg = get_config(arch, smoke=True)
    shape = _shape(kind)
    params = abstract_lm_params(cfg)[0]
    specs = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            step, opt = PS.make_train_step(cfg, "adamw")
            step(params, opt.init(params), specs)
        elif shape.kind == "prefill":
            PS.make_prefill_step(cfg)(params, specs)
        else:
            mem = {"memory": specs["memory"]} if "memory" in specs else {}
            PS.make_serve_step(cfg)(params, specs["token"], S - 1, specs["caches"], **mem)
    return counter.get_total_flops()


@pytest.mark.parametrize("case", CASES)
def test_per_device_flops_between_a_share_and_the_whole(records, case):
    arch, kind = case.split("/")
    whole = _unsharded_flops(arch, kind)
    got = records[case]["hlo_flops"]
    assert whole / 8 <= got <= whole, (got, whole)


def test_collectives_on_a_sharded_mesh_only(records):
    for case in CASES:
        coll = records[case]["collectives"]
        assert coll["total_bytes"] > 0 and sum(coll["counts_by_kind"].values()) > 0, case
        assert set(coll["bytes_by_kind"]) <= set(PR.COLLECTIVES)
    for kind in KINDS:
        rec = records[f"1x1/{kind}"]
        assert rec["status"] == "ok" and rec["chips"] == 1
        assert rec["collectives"]["total_bytes"] == 0, rec["collectives"]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equal_the_reference(arch):
    from repro.configs import get_config as jget_config
    from repro.configs.base import INPUT_SHAPES as JSHAPES
    from repro.launch.roofline import model_flops as jmodel_flops

    for name, shape in INPUT_SHAPES.items():
        assert PR.model_flops(get_config(arch), shape) == jmodel_flops(jget_config(arch), JSHAPES[name]), name


@pytest.mark.parametrize("args", [(1e15, 2e12, 3e11, 256), (148e12, 7.1e11, 1.9e11, 512), (1.0, 1e13, 0.0, 1)])
def test_roofline_terms_are_the_reference_formula_on_h100_constants(monkeypatch, args):
    import repro.launch.roofline as JR

    monkeypatch.setattr(JR, "PEAK_FLOPS_BF16", PM.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JR, "HBM_BW", PM.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", PM.NVLINK_BW)
    assert PR.roofline_terms(*args) == JR.roofline_terms(*args, links_per_chip=PM.NVLINK_LINKS)
    assert (PM.PEAK_FLOPS_BF16, PM.HBM_BW, PM.NVLINK_BW * PM.NVLINK_LINKS) == (989e12, 3.35e12, 450e9)


def test_the_cli_writes_a_record_a_case(tmp_path, monkeypatch):
    mesh = PM.make_fake_mesh((2, 4), ("data", "model"), "cpu")
    monkeypatch.setattr(D, "make_production_mesh", lambda multi_pod, device: mesh)
    monkeypatch.setattr(D, "get_config", lambda arch, smoke=False: get_config(arch, smoke=True))
    monkeypatch.setitem(D.INPUT_SHAPES, "decode_32k", _shape("decode_32k"))
    got = D.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path),
                  "--device", "cpu"])
    assert [r["status"] for r in got] == ["ok"]
    rec = json.loads((tmp_path / "qwen2-7b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["roofline"]["chips"] == 8
    assert D.main(["--arch", "qwen2-7b", "--shape", "decode_32k", "--out", str(tmp_path), "--device", "cpu"]) == []


def _grads_and_flops(cfg, params, batch):
    """The train step's gradient (the loss's, before clipping) and the
    FLOPs of its forward and backward."""
    from repro_torch.models import transformer as T

    live = [v.detach().clone().requires_grad_() for v in tree_leaves(params)]
    with FlopCounterMode(display=False) as counter:
        p1 = T.one_node(tree_unflatten(params, live))
        loss = T.lm_loss(p1, cfg, batch["tokens"][None], batch["labels"][None])[0]
        grads = torch.autograd.grad(loss, live)
    return grads, counter.get_total_flops()


def test_dots_policy_saves_the_products_with_no_batch_dimension():
    """A phi3-smoke train step under "dots" and under "nothing": the same
    gradient bit for bit; the "dots" run's FLOPs are fewer by exactly the
    forward FLOPs of the saved products, every repeat's one-model linears
    (q, k, v and o, and the MLP's three), which its recompute serves from
    the record."""
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b", smoke=True), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = abstract_lm_params(cfg)[0]
    params = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 0.05, params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    g_nothing, f_nothing = _grads_and_flops(dataclasses.replace(cfg, remat_policy="nothing"), params, batch)
    g_dots, f_dots = _grads_and_flops(dataclasses.replace(cfg, remat_policy="dots"), params, batch)
    assert all(torch.equal(a, b) for a, b in zip(g_nothing, g_dots))
    d, hd, H, KV, f = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    per_token = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    assert f_nothing - f_dots == 2 * tokens.numel() * per_token * cfg.num_layers
