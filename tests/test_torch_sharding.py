"""The port's logical-axis specs and partitioning rules against the JAX
reference's.

* tests/test_sharding.py's seven assertions, on the port's rules over a
  fake 8-rank (data 2, model 4) mesh;
* `resolve` equal to the reference's over a grid of shapes x rule sets x
  meshes ((2, 4) and (2, 2, 2) with a pod axis);
* `abstract_lm_params`: the spec tree, and every leaf's shape and dtype,
  equal to the reference's (``jax.eval_shape`` of its init) for the ten
  configs, smoke and full; nothing is allocated (meta tensors);
* `tree_shardings`: every leaf's spec, and the DTensor placements it
  stands for, equal to the reference's ``NamedSharding`` specs;
* tests/test_configs_smoke.py::test_abstract_params_match_concrete on the
  port: the abstract tree's shapes, dtypes and specs are the drawn init's.

The reference runs once in a subprocess with 8 forced host devices (its
meshes need them); about 10 s."""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.types import tree_leaves, tree_map
from repro_torch.launch.mesh import make_fake_mesh, release
from repro_torch.models import transformer as PT
from repro_torch.sharding import partitioning as PP

SHAPES = [(64, 128), (64, 130), (1, 5), (8, 64, 4, 16), (16, 48), (2, 6), (0, 8), (12, 4), (32, 32, 8)]
AXES = [("embed", "ffn"), ("embed", "ffn"), ("batch", None), ("batch", "cache_seq", None, None), ("vocab", "embed"),
        ("batch", "heads_hd"), ("moe_embed", "kv_hd"), ("ssm_in", "experts"), ("layers", "embed", "seq")]
RULES = ["DEFAULT_RULES", "MULTIPOD_RULES", "DECODE_RULES", "MULTIPOD_DECODE_RULES", "MOE_LOCAL_RULES",
         "MULTIPOD_MOE_LOCAL_RULES"]
MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import json, sys
import jax
import numpy as np
from repro.configs import ARCH_NAMES, get_config
from repro.models.transformer import abstract_lm_params
from repro.sharding import partitioning as P

spec = json.loads(sys.argv[1])
meshes = {k: jax.make_mesh(tuple(s), tuple(a), axis_types=(jax.sharding.AxisType.Auto,) * len(a))
          for k, (s, a) in spec["meshes"].items()}
out = {"resolve": {}, "abstract": {}, "shardings": {}}
for mk, mesh in meshes.items():
    for rk in spec["rules"]:
        for shape, axes in zip(spec["shapes"], spec["axes"]):
            out["resolve"][f"{mk}/{rk}/{shape}/{axes}"] = str(P.resolve(tuple(axes), tuple(shape), mesh,
                                                                         getattr(P, rk)))
m = meshes["2x4"]
out["rules"] = {"ffn": str(P.resolve(("embed", "ffn"), (64, 128), m)),
                "indivisible": str(P.resolve(("embed", "ffn"), (64, 130), m)),
                "batch1": str(P.resolve(("batch", None), (1, 5), m)),
                "cache": str(P.resolve(("batch", "cache_seq", None, None), (8, 64, 4, 16), m)),
                "decode_embed": str(P.rules_for_mesh(m, "decode_stationary")["embed"]),
                "moe_embed": str(P.rules_for_mesh(m, "moe_local")["moe_embed"])}
is_axes = lambda s: isinstance(s, tuple) and all(isinstance(e, (str, type(None))) for e in s)
for name in ARCH_NAMES:
    for smoke in (True, False):
        shapes, specs = abstract_lm_params(get_config(name, smoke=smoke))
        leaves = jax.tree.leaves(shapes)
        out["abstract"][f"{name}/{smoke}"] = {
            "shapes": [list(l.shape) for l in leaves],
            "dtypes": [str(l.dtype) for l in leaves],
            "specs": [list(s) for s in jax.tree.leaves(specs, is_leaf=is_axes)],
        }
        if smoke:
            for mk, mesh in meshes.items():
                sh = P.tree_shardings(specs, shapes, mesh)
                out["shardings"][f"{name}/{mk}"] = [
                    [list(p) if isinstance(p, tuple) else p for p in s.spec]
                    for s in jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    spec = dict(shapes=SHAPES, axes=AXES, rules=RULES, meshes=MESHES)
    res = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(spec)], capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def meshes():
    """Both 8-rank fake meshes (one fake world of 8 ranks)."""
    out = {k: make_fake_mesh(s, a, "cpu") for k, (s, a) in MESHES.items()}
    yield out
    release()


def _specs(tree) -> list:
    return [list(s) for s in tree_leaves(tree)]


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def test_partitioning_rules(meshes):
    """tests/test_sharding.py's assertions, on the port."""
    mesh = meshes["2x4"]
    assert str(PP.resolve(("embed", "ffn"), (64, 128), mesh)) == "PartitionSpec('data', 'model')"
    assert str(PP.resolve(("embed", "ffn"), (64, 130), mesh)) == "PartitionSpec('data', None)"  # ffn dropped
    assert str(PP.resolve(("batch", None), (1, 5), mesh)) == "PartitionSpec(None, None)"
    assert str(PP.resolve(("batch", "cache_seq", None, None), (8, 64, 4, 16), mesh)) == \
        "PartitionSpec('data', 'model', None, None)"
    shapes, specs = PT.abstract_lm_params(get_config("mixtral-8x7b", smoke=True))
    sh = PP.tree_shardings(specs, shapes, mesh)
    assert len(tree_leaves(sh)) == len(tree_leaves(shapes))  # one sharding a param
    assert str(PP.rules_for_mesh(mesh, "decode_stationary")["embed"]) == "()"
    assert str(PP.rules_for_mesh(mesh, "moe_local")["moe_embed"]) == "()"


def test_rules_print_as_the_reference(reference, meshes):
    mesh = meshes["2x4"]
    got = {"ffn": str(PP.resolve(("embed", "ffn"), (64, 128), mesh)),
           "indivisible": str(PP.resolve(("embed", "ffn"), (64, 130), mesh)),
           "batch1": str(PP.resolve(("batch", None), (1, 5), mesh)),
           "cache": str(PP.resolve(("batch", "cache_seq", None, None), (8, 64, 4, 16), mesh)),
           "decode_embed": str(PP.rules_for_mesh(mesh, "decode_stationary")["embed"]),
           "moe_embed": str(PP.rules_for_mesh(mesh, "moe_local")["moe_embed"])}
    assert got == reference["rules"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_resolve_equals_the_reference(reference, meshes, mesh_name, rules):
    for shape, axes in zip(SHAPES, AXES):
        key = f"{mesh_name}/{rules}/{list(shape)}/{list(axes)}"
        assert str(PP.resolve(axes, shape, meshes[mesh_name], getattr(PP, rules))) == reference["resolve"][key], key


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_params_equal_the_reference(reference, name, smoke):
    shapes, specs = PT.abstract_lm_params(get_config(name, smoke=smoke))
    want = reference["abstract"][f"{name}/{smoke}"]
    leaves = tree_leaves(shapes)
    assert all(t.device.type == "meta" for t in leaves)
    assert [list(t.shape) for t in leaves] == want["shapes"]
    assert [_dtype(t) for t in leaves] == want["dtypes"]
    assert _specs(specs) == want["specs"]


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_tree_shardings_equal_the_reference(reference, meshes, name):
    from torch.distributed.tensor import Replicate, Shard

    shapes, specs = PT.abstract_lm_params(get_config(name, smoke=True))
    for mesh_name, mesh in meshes.items():
        sh = tree_leaves(PP.tree_shardings(specs, shapes, mesh))
        got = [[list(p) if isinstance(p, tuple) else p for p in s.spec] for s in sh]
        assert got == reference["shardings"][f"{name}/{mesh_name}"], mesh_name
        for s, t in zip(sh, tree_leaves(shapes)):
            assert len(s.spec) == t.dim()
            for axis, pl in zip(mesh.mesh_dim_names, s.placements):
                dims = [d for d, p in enumerate(s.spec) if p == axis or (isinstance(p, tuple) and axis in p)]
                assert pl == (Shard(dims[0]) if dims else Replicate())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_params_match_concrete(name):
    """The port of tests/test_configs_smoke.py's case: the abstract tree's
    shapes, dtypes and specs are those of the drawn init's."""
    cfg = get_config(name, smoke=True)
    shapes, specs = PT.abstract_lm_params(cfg)
    params, specs2 = PT._init_lm(cfg, torch.Generator().manual_seed(0))
    assert tree_leaves(tree_map(lambda t: [tuple(t.shape), t.dtype], shapes)) == \
        tree_leaves(tree_map(lambda t: [tuple(t.shape), t.dtype], params))
    assert specs == specs2
    drawn = PT.init_lm_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(drawn), tree_leaves(params)))
