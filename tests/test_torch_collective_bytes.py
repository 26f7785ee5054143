"""The LM transport round's ``collective_bytes`` against the reference's HLO
walk, at ``benchmarks/bench_lm.py``'s fixed gate config (m = 8 on a ring,
the 2-layer lm-bench model in bf16, block top-k 0.1 of blocks of 1,024,
chunk 1 << 14, K = 3) for both of its policies: ``lm_fused``
(``DeviceTransport(fused=True)``) and ``lm_host`` (the dense exchange with
the host's chunked codec).

The reference's side is lowered and walked only, never run (its LM device
run aborts at times in XLA's CPU all-reduce, ROADMAP §C):
``repro.obs.compute.round_cost`` on its built round, in a subprocess with 8
forced host devices, started first so that it compiles while the port's
rounds run.  The port's side is one round of ``run(transport=...)`` with
``obs=``, its exchanges counted by `Collectives`.

The reference's lowered program moves each bf16 leaf at bf16, and XLA's
CPU compiler widens every bf16 collective to f32 before the walk reads it;
the port counts what it moves, at each tensor's dtype.  So the test holds,
exactly: the collectives' element counts by kind, their dtypes against the
reference's lowered program, the bytes of those elements at the widths
XLA:CPU gives them against the reference's walk, the port's own bytes
against the closed form `device_collective_bytes`, and the fused exchange
below the dense one in both packages (``bench_lm``'s claim).

About 25 s on one worker, most of it the reference's two compiles."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.c2dfb import C2DFBConfig, run
from repro_torch.core.lm_bilevel import init_node_params, make_lm_bilevel
from repro_torch.core.topology import ring
from repro_torch.core.types import tree_leaves
from repro_torch.data.synthetic import node_streams
from repro_torch.obs import MemorySink
from repro_torch.obs.compute import Collectives, device_collective_bytes
from repro_torch.transport import DeviceTransport

ROOT = Path(__file__).resolve().parents[1]
POLICIES = {"lm_fused": True, "lm_host": False}
# the reference's dtype names of the port's tensors
HLO_DTYPE = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int32: "s32"}

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import dataclasses, json, re
import jax
from benchmarks import bench_lm
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.c2dfb import init_state
from repro.obs.compute import round_cost
from repro.transport import DeviceTransport
from repro.transport.device import make_device_round

G = bench_lm.GATE
# the gate's own build with the parameters' shapes and dtypes only: lowering reads no value
init = bench_lm.init_node_params
bench_lm.init_node_params = lambda mcfg, key, m: jax.eval_shape(lambda k: init(mcfg, k, m), key)
problem, topo, cfg, x0, y0 = bench_lm._build()
state = jax.eval_shape(lambda x, y: init_state(problem, cfg, x, y), x0, y0)
leaves = lambda t: [[list(v.shape), str(v.dtype)] for v in jax.tree.leaves(t)]
out = {"gate": G, "model": dataclasses.asdict(bench_lm._model_cfg()), "x": leaves(x0), "y": leaves(y0),
       "cfg": {k: getattr(cfg, k) for k in ("lam", "eta_out", "gamma_out", "eta_in", "gamma_in", "K", "compressor",
                                            "comp_ratio", "comp_block")}}
for name, fused in (("lm_fused", True), ("lm_host", False)):
    # the engine's round on its arguments' shapes and placements (repro.transport.engine.run_c2dfb_transport):
    # lowered, not run
    tr = DeviceTransport(link=bench_lm.PROFILE, seed=0, fused=fused, chunk=G["chunk"]).bind(topo)
    fn = make_device_round(problem, topo, cfg, tr.mesh, tr.axis, jit=True, fused=fused)
    shard = lambda t: jax.tree.map(
        lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=NamedSharding(tr.mesh, P(tr.axis))), t)
    args = tuple(shard(p) for p in (state.x, state.s_x, state.u_prev, state.inner_y, state.inner_z)) + (
        jax.random.split(jax.random.PRNGKey(G["seed"]), 1)[0], shard(problem.data_f), shard(problem.data_g))
    cost = round_cost((name,), fn, *args)
    lowered = jax.jit(fn).lower(*args).as_text(dialect="hlo")
    kinds = sorted({m.group(1) for m in re.finditer(r"= (\w+)\[[\d,]*\][^ ]* collective-permute\(", lowered)})
    out[name] = {"collective_bytes": cost.collective_bytes, "lowered_dtypes": kinds,
                 "other_collectives": [c for c in ("all-gather(", "all-reduce(", "all-to-all(") if c in lowered]}
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def reference_proc():
    """The reference's lowering, started at once (it takes most of this
    file's time) and read by `reference`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")] + env.get("PYTHONPATH", "").split(os.pathsep))
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_proc, port):
    out, err = reference_proc.communicate(timeout=600)
    assert reference_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port(reference_proc):
    """Both policies' round 0 on the CPU at the gate config, with the
    collectives counted: (transport, counter, x0, y0, cfg) a policy.  The
    config is bench_lm's GATE and lm-bench model (benchmarks/bench_lm.py:79-
    120), written here for the port's classes."""
    m, vocab = 8, 256
    model = ModelConfig(name="lm-bench", arch_type="dense", pattern=("full",), mlp_type="swiglu", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=vocab)

    def data(seed):
        bs = [s.next_batch() for s in node_streams(m, vocab, 64, 2, seed=seed)]
        return {k: torch.from_numpy(np.stack([b[k] for b in bs])) for k in ("tokens", "labels")}

    problem = make_lm_bilevel(model, data(0), data(1), m)
    x0, y0 = init_node_params(model, torch.Generator().manual_seed(0), m)
    cfg = C2DFBConfig(lam=10.0, eta_out=0.02, gamma_out=0.5, eta_in=0.06, gamma_in=0.5, K=3, compressor="block_topk",
                      comp_ratio=0.1, comp_block=1024)
    out = {}
    for name, fused in POLICIES.items():
        tr = DeviceTransport(link="wan", seed=0, fused=fused, chunk=1 << 14)
        with Collectives() as counter:
            run(problem, ring(m), cfg, x0, y0, T=1, device="cpu", transport=tr, obs=MemorySink())
        out[name] = (tr, counter, x0, y0, cfg, model)
    return out


def test_the_port_runs_the_reference_gate_config(reference, port):
    """The port's model, data shapes and C2DFB config are bench_lm's: every
    leaf of x and y at the reference's shape and dtype."""
    tr, _, x0, y0, cfg, model = port["lm_fused"]
    g, mcfg = reference["gate"], reference["model"]
    assert (g["m"], g["B"], g["S"], g["K"], g["block"], g["ratio"], g["chunk"]) == (8, 2, 64, 3, 1024, 0.1, 1 << 14)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size", "mlp_type",
              "pattern"):
        assert getattr(model, f) == (tuple(mcfg[f]) if f == "pattern" else mcfg[f]), f
    for f, v in reference["cfg"].items():
        assert getattr(cfg, f) == v, f
    for tree, want in ((x0, reference["x"]), (y0, reference["y"])):
        assert [[list(v.shape), HLO_DTYPE[v.dtype].replace("bf16", "bfloat16").replace("f32", "float32")]
                for v in tree_leaves(tree)] == want
    assert tr.chunk == g["chunk"]


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_lm_gate_collective_bytes_equal_the_reference_walk(reference, port, name):
    """The port's collectives are the reference program's, kind by kind and
    dtype by dtype (neighbour shifts only; bf16 dense leaves, and on the
    fused path f32 values and int32 lanes); their elements at XLA:CPU's
    widths (bf16 widened to f32) are the reference's walk exactly; the
    port's bytes at the dtypes it moves are the transport's
    ``cost.collective_bytes`` and the closed form."""
    tr, counter, x0, y0, cfg, _ = port[name]
    want = reference[name]
    assert reference[name]["other_collectives"] == []
    assert {kind for kind, _ in counter.elements} == {"collective-permute"}
    assert sorted({HLO_DTYPE[dt] for _, dt in counter.elements}) == want["lowered_dtypes"]
    widened = sum(n * (4 if dt == torch.bfloat16 else dt.itemsize) for (_, dt), n in counter.elements.items())
    assert float(widened) == want["collective_bytes"]
    assert isinstance(tr.cost.collective_bytes, float) and tr.cost.collective_bytes == float(counter.bytes)
    assert tr.cost.collective_bytes == device_collective_bytes(ring(8), cfg, x0, y0, POLICIES[name])
    assert tr.cost.collective_bytes < want["collective_bytes"]  # the bf16 leaves move at 2 bytes here


def test_lm_gate_fused_moves_fewer_collective_bytes(reference, port):
    """bench_lm's claim for the fused exchange (coll_f < coll_h), in both
    packages."""
    assert reference["lm_fused"]["collective_bytes"] < reference["lm_host"]["collective_bytes"]
    assert port["lm_fused"][0].cost.collective_bytes < port["lm_host"][0].cost.collective_bytes
