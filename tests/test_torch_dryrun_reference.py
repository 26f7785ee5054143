"""The port's dry run (`repro_torch.launch.dryrun`) held to the JAX
reference's own compiled dry run at production size.

The reference side runs once in a subprocess with 512 forced host
devices: ``repro.launch.dryrun.dryrun_one(arch, shape, False)`` lowers and
compiles each step on its 16 x 16 mesh and reads XLA's
``memory_analysis`` and its trip-count-aware HLO walk
(``launch/hlo_cost.py``).  Its config is cut to one repeat of its pattern
exactly as the port's ``dryrun.config(arch, layers=1)`` cuts it; its
input shapes are its own, uncut.  The port side runs
``dryrun_one(arch, shape, False, device="cpu", layers=1)`` on the fake
256-rank mesh.  Per case (every width the config's):

* argument bytes per device equal;
* per-device FLOPs within 0.95-1.05 of the reference's;
* temp bytes per device at most 1.5 x the reference's: XLA's CPU buffer
  assignment is not an allocator, and nothing bounds temp from below here
  (the card's own allocator does, `chip_smoke.py` phase 15 (b));
* collective bytes per device at most 2 x the reference's: DTensor's
  collectives are not GSPMD's by kind (an all-reduce where XLA may issue
  a reduce-scatter and an all-gather).

The eight cases cover each layout the bounds guard: the vocabulary-
parallel cross-entropy and embedding (every train case), heads that the
model axis does not divide (qwen2-7b's 28 on 16), masks at each device's
batch (the prefills) and the decode cache written on its shards.  About
60 s on one worker, half of it the reference's compiles."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM

CASES = [
    "phi3-mini-3.8b/train_4k",
    "qwen2-7b/train_4k",
    "gemma2-27b/train_4k",
    "nemotron-4-15b/train_4k",
    "phi3-mini-3.8b/prefill_32k",
    "qwen2-7b/prefill_32k",
    "phi3-mini-3.8b/decode_32k",
    "gemma2-27b/decode_32k",
]
LAYERS = 1
FLOPS_BOUND = (0.95, 1.05)
TEMP_BOUND = 1.5
COLLECTIVE_BOUND = 2.0

SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import dataclasses, json, sys
import jax
assert len(jax.devices()) == 512
from repro.configs import get_config
import repro.launch.dryrun as D

spec = json.loads(sys.argv[1])
cut = spec["cut"]
D.get_config = lambda a: dataclasses.replace(get_config(a), **cut[a])
out = {}
for case in spec["cases"]:
    arch, shape = case.split("/")
    rec = D.dryrun_one(arch, shape, False)
    assert rec["status"] == "ok", (case, rec.get("error"), rec.get("traceback"))
    out[case] = {"argument": rec["memory_analysis"]["argument_size_in_bytes"],
                 "temp": rec["memory_analysis"]["temp_size_in_bytes"],
                 "flops": rec["hlo_flops"], "collectives": rec["collectives"]["total_bytes"]}
print(json.dumps(out))
"""


def _cut(arch: str) -> dict:
    cfg = D.config(arch, layers=LAYERS)
    return {"num_layers": cfg.num_layers, "enc_layers": cfg.enc_layers}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    spec = {"cases": CASES, "cut": {c.split("/")[0]: _cut(c.split("/")[0]) for c in CASES}}
    res = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(spec)], capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    out = {}
    mesh = PM.make_production_mesh(multi_pod=False, device="cpu")
    for case in CASES:
        arch, shape = case.split("/")
        rec = D.dryrun_one(arch, shape, False, device="cpu", mesh=mesh, layers=LAYERS)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["mesh"] == "16x16" and rec["layers"] == _cut(arch)["num_layers"]
        out[case] = {"argument": rec["memory_analysis"]["argument_size_in_bytes"],
                     "temp": rec["memory_analysis"]["temp_size_in_bytes"],
                     "flops": rec["hlo_flops"], "collectives": rec["collectives"]["total_bytes"]}
    yield out
    PM.release()


@pytest.mark.parametrize("case", CASES)
def test_argument_bytes_equal_the_reference(reference, port, case):
    assert port[case]["argument"] == reference[case]["argument"]


@pytest.mark.parametrize("case", CASES)
def test_flops_per_device_near_the_reference(reference, port, case):
    ratio = port[case]["flops"] / reference[case]["flops"]
    assert FLOPS_BOUND[0] <= ratio <= FLOPS_BOUND[1], (port[case]["flops"], reference[case]["flops"], ratio)


@pytest.mark.parametrize("case", CASES)
def test_temp_bytes_within_the_bound(reference, port, case):
    ratio = port[case]["temp"] / reference[case]["temp"]
    assert ratio <= TEMP_BOUND, (port[case]["temp"], reference[case]["temp"], ratio)


@pytest.mark.parametrize("case", CASES)
def test_collective_bytes_within_the_bound(reference, port, case):
    ratio = port[case]["collectives"] / reference[case]["collectives"]
    assert ratio <= COLLECTIVE_BOUND, (port[case]["collectives"], reference[case]["collectives"], ratio)
