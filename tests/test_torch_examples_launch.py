"""The transport, serving and LM twins on the CPU
(``examples/transport_backends_torch.py``, ``serve_batch_torch.py``,
``decentralized_llm_bilevel_torch.py``), by the rules and helpers of
``test_torch_examples.py``.

* transport_backends: the reference's script needs 8 XLA host devices,
  forced before jax is imported, so it runs in a subprocess (as
  tests/test_torch_device_transport.py's reference does) at the reduced
  size (n = 240, p = 30, ``run`` capped at 3 rounds) and hands back its
  printed lines and its x0 and y0; the twin runs here on those arrays,
  and the two outputs agree line by line (the device row's host wall left
  out).
* serve_batch and decentralized_llm_bilevel (``--preset smoke --steps 2``)
  run as ``--device cpu`` subprocesses, as tests/test_torch_launchers.py
  runs the CLIs: the twins' weights are torch draws, so their values are
  not the reference's, but the LM twin's parameter counts and its
  ``[c2dfb] wire bytes/round`` line must equal the reference's own analytic
  count for the preset.

About 35 s on one worker."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np

from repro_torch.core.convert import from_numpy
from repro_torch.data import bilevel_tasks as ptasks
from test_torch_examples import EXAMPLES, ROOT, assert_same_printed, capped, load, printed

TRANSPORT_SMALL = dict(n=240, p=30)
TRANSPORT_T = 3

REFERENCE = r"""
import contextlib, importlib.util, inspect, io, json, sys
import numpy as np
spec = importlib.util.spec_from_file_location("transport_backends", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)  # forces the 8 host devices, then imports jax
small, T = json.loads(sys.argv[2]), int(sys.argv[3])
factory, run = mod.coefficient_tuning_task, mod.run
bundles = []

def reduced(**kw):
    bundles.append(factory(**{**kw, **small}))
    return bundles[-1]

def capped(*args, **kw):
    bound = inspect.signature(run).bind(*args, **kw)
    bound.arguments["T"] = min(bound.arguments["T"], T)
    return run(*bound.args, **bound.kwargs)

mod.coefficient_tuning_task, mod.run = reduced, capped
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    mod.main()
b = bundles[0]
print(json.dumps({"stdout": buf.getvalue(), "x0": np.asarray(b.x0).tolist(), "y0": np.asarray(b.y0).tolist()}))
"""


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["OMP_NUM_THREADS"] = "1"  # as the fixture sets torch's threads in process
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_transport_backends():
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(EXAMPLES / "transport_backends.py"), json.dumps(TRANSPORT_SMALL),
         str(TRANSPORT_T)],
        capture_output=True, text=True, env=_env(), timeout=600, cwd=ROOT,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.splitlines()[-1])

    twin = load("transport_backends_torch")

    def factory(device=None, **kw):
        pb = ptasks.coefficient_tuning_task(**{**kw, **TRANSPORT_SMALL}, device=device)
        return dataclasses.replace(pb, x0=from_numpy(np.asarray(ref["x0"], np.float32), device),
                                   y0=from_numpy(np.asarray(ref["y0"], np.float32), device))

    twin.coefficient_tuning_task = factory
    twin.run = capped(twin.run, TRANSPORT_T)
    got = printed(twin.main, ["--device", "cpu"])
    assert_same_printed(ref["stdout"], got, phrases=[("shard_map collectives", "in-process ranks on one device")],
                        machine=[r"wall_s=([\d.]+)"])


def _run_twin(name: str, args: list) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(EXAMPLES / f"{name}_torch.py")] + args + ["--device", "cpu"],
                          capture_output=True, text=True, env=_env(), timeout=600, cwd=ROOT)


def test_serve_batch():
    res = _run_twin("serve_batch", [])
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[serve] prefill 4x64 in ")
    assert lines[1].startswith("[serve] decoded 15 steps x 4 seqs in ") and lines[1].endswith(" tok/s on cpu)")
    assert lines[2].startswith("[serve] sample output ids: [") and len(lines) == 3


def _reference_preset_lines(preset: str, m: int = 4, K: int = 5, lr: float = 0.02) -> list:
    """The reference launcher's first two lines for the LM example's
    preset (``run_bilevel``'s parameter counts and its analytic
    ``[c2dfb] wire bytes/round`` on its own initial state's shapes; both
    read sizes only, so the state is zeros of ``jax.eval_shape``'s shapes,
    the init never run)."""
    from repro.configs.base import ModelConfig
    from repro.core.c2dfb import C2DFBConfig, round_wire_bytes
    from repro.core.lm_bilevel import init_node_params
    from repro.core.topology import make_topology

    presets = load("decentralized_llm_bilevel").PRESETS
    cfg = ModelConfig(name=f"bilevel-lm-{preset}", arch_type="dense", pattern=("full",), mlp_type="swiglu",
                      **presets[preset])
    x0, y0 = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                          jax.eval_shape(lambda: init_node_params(cfg, jax.random.PRNGKey(0), m)))
    state = types.SimpleNamespace(x=x0, inner_y=types.SimpleNamespace(d=y0), inner_z=types.SimpleNamespace(d=y0))
    ccfg = C2DFBConfig(lam=10.0, eta_out=lr, gamma_out=0.5, eta_in=lr * 3, gamma_in=0.5, K=K, compressor="topk",
                       comp_ratio=0.2)
    wire = round_wire_bytes(state, ccfg, make_topology("ring", m))
    nx, ny = (sum(v.size for v in jax.tree.leaves(t)) // m for t in (x0, y0))
    return [f"[c2dfb] {cfg.name}: upper {nx/1e6:.2f}M / lower {ny/1e6:.3f}M params x {m} nodes, topo=ring",
            f"[c2dfb] wire bytes/round: {wire['total_bytes']/1e6:.2f} MB (inner {wire['inner_bytes']/1e6:.2f} MB)"]


def test_decentralized_llm_bilevel():
    res = _run_twin("decentralized_llm_bilevel", ["--preset", "smoke", "--steps", "2"])
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert lines[:2] == _reference_preset_lines("smoke")
    assert [ln.split()[:2] for ln in lines[2:4]] == [["round", "0"], ["round", "1"]]
    assert lines[4].startswith("[c2dfb] 2 rounds in ") and len(lines) == 5
