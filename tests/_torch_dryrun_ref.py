"""The port's dry run held to the JAX reference's own compiled dry run:
the reference's side in a subprocess, the port's in process.

A case is ``"arch/shape"`` or ``"arch/shape/variant"``.  The reference side
runs once a test file, in a subprocess with 512 forced host devices:
``repro.launch.dryrun.dryrun_one(arch, shape, False, variant=variant)``
lowers and compiles each step on its 16 x 16 mesh and reads XLA's
``memory_analysis`` and its trip-count-aware HLO walk
(``launch/hlo_cost.py``).  Its config is cut to one repeat of its pattern
exactly as the port's ``dryrun.config(arch, layers=1)`` cuts it; its
input shapes are its own, uncut.  The port side runs ``dryrun_one(arch,
shape, False, variant=variant, device="cpu", layers=1)`` on the fake
256-rank mesh.  `start_reference` starts the subprocess and returns at
once, so that the port's side (`port_records`) runs while the reference
compiles; `reference_records` waits for it.

Each record keeps the four counts the bounds compare, per device:
argument, temp and collective bytes, and FLOPs.  Run as a script, it
prints each case's port-over-reference ratios:

    PYTHONPATH=src:tests python tests/_torch_dryrun_ref.py mixtral-8x7b/decode_32k \
        gemma2-27b/train_4k/remat_dots
"""

import json
import os
import subprocess
import sys

from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM

LAYERS = 1
#: seconds the reference's compiles may take
TIMEOUT = 600

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
    arch, shape, *variant = case.split("/")
    rec = D.dryrun_one(arch, shape, False, variant=variant[0] if variant else "baseline")
    assert rec["status"] == "ok", (case, rec.get("error"), rec.get("traceback"))
    out[case] = {"argument": rec["memory_analysis"]["argument_size_in_bytes"],
                 "temp": rec["memory_analysis"]["temp_size_in_bytes"],
                 "flops": rec["hlo_flops"], "collectives": rec["collectives"]["total_bytes"]}
print(json.dumps(out))
"""


def split_case(case: str) -> tuple[str, str, str]:
    """``"arch/shape[/variant]"`` -> (arch, shape, variant)."""
    arch, shape, *variant = case.split("/")
    return arch, shape, variant[0] if variant else "baseline"


def cut(arch: str) -> dict:
    """The config fields that cut ``arch`` to `LAYERS` layers, the port's
    cut (`repro_torch.launch.dryrun.config`)."""
    cfg = D.config(arch, layers=LAYERS)
    return {"num_layers": cfg.num_layers, "enc_layers": cfg.enc_layers}


def start_reference(cases: list) -> subprocess.Popen:
    """The reference's dry run of ``cases``, started in a subprocess."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    spec = {"cases": cases, "cut": {split_case(c)[0]: cut(split_case(c)[0]) for c in cases}}
    return subprocess.Popen([sys.executable, "-c", SCRIPT, json.dumps(spec)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def reference_records(proc: subprocess.Popen) -> dict:
    """The records of a `start_reference` subprocess, once it ends."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def port_records(cases: list) -> dict:
    """The port's dry run of ``cases`` on the fake 16 x 16 mesh."""
    out = {}
    mesh = PM.make_production_mesh(multi_pod=False, device="cpu")
    try:
        for case in cases:
            arch, shape, variant = split_case(case)
            rec = D.dryrun_one(arch, shape, False, variant=variant, device="cpu", mesh=mesh, layers=LAYERS)
            assert rec["status"] == "ok", rec.get("traceback")
            assert rec["mesh"] == "16x16" and rec["layers"] == cut(arch)["num_layers"]
            out[case] = {"argument": rec["memory_analysis"]["argument_size_in_bytes"],
                         "temp": rec["memory_analysis"]["temp_size_in_bytes"],
                         "flops": rec["hlo_flops"], "collectives": rec["collectives"]["total_bytes"]}
    finally:
        PM.release()
    return out


def both(cases: list) -> tuple[dict, dict]:
    """(reference records, port records) of ``cases``, the two sides run at
    once."""
    proc = start_reference(cases)
    try:
        port = port_records(cases)
    except BaseException:
        proc.kill()
        raise
    return reference_records(proc), port


if __name__ == "__main__":
    cases = sys.argv[1:]
    reference, port = both(cases)
    for case in cases:
        r, p = reference[case], port[case]
        print(f"{case}: argument {p['argument'] - r['argument']:+d} B, temp {p['temp'] / r['temp']!r}, "
              f"FLOPs {p['flops'] / r['flops']!r}, collectives {p['collectives'] / r['collectives']!r}")
