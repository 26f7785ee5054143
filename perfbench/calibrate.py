"""Readings that a cell's check limits are set from: the numbers `compare`
gives for sound runs of the program, for the control, and for each fault
planted in the program, against the plain reference, on given seeds, at
the cell's own size.  No window is run.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 3] [--faults half_batch no_exchange altered_answer ...] [--out FILE]

The control is what the family names: for a float32 configuration the
program itself with TF32 on (its own lower-precision path), for a
bfloat16 one the reference computed in float8.  The faults are
`perfbench.faults`'s, by name.  Prints one JSON line a
seed (and appends it to ``--out``); the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(config: dict, workload: dict, seed: int, device, control: bool, plant: list,
             leaves: bool = False) -> dict:
    """One seed's readings: ``sound``, ``control`` and each fault's gaps."""
    from perfbench import faults, harness

    fam = harness.family(config)
    out: dict = {"seed": seed}
    recs = {}
    t0 = time.perf_counter()
    prog = harness.build_program(config, workload, seed, device)
    recs["sound"] = harness.check_rounds(prog)[1]
    _free(device)
    if control and fam.CONTROL == "program_tf32":
        recs["control"] = harness.check_rounds(prog, tf32=True)[1]
    for name in plant:
        prog["problem"].graphs.forget()  # the sound run's memo of x's values
        recs[name] = harness.check_rounds(faults.plant(prog, [name]))[1]
        _free(device)
    del prog
    _free(device)
    out["program_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = harness.reference_rounds(config, workload, seed, device, harness.precision_of(config))
    out["reference_s"] = time.perf_counter() - t0
    if control and fam.CONTROL != "program_tf32":
        _free(device)
        recs["control"] = harness.reference_rounds(config, workload, seed, device, fam.CONTROL)
    for name, rec in recs.items():
        gaps = harness.compare(rec, ref)
        out[name] = gaps
        if leaves:
            out[f"{name}_leaves"] = {"grads": rec["grads"], "change": rec["change"],
                                     "hypergrad_norm": rec["hypergrad_norm"], "measured_bytes": rec["measured_bytes"]}
    if leaves:
        out["reference_leaves"] = {"grads": ref["grads"], "change": ref["change"],
                                   "hypergrad_norm": ref["hypergrad_norm"], "measured_bytes": ref["measured_bytes"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3, help="how many of the seeds also read the control")
    ap.add_argument("--faults", nargs="*", default=[], help="faults to plant, on the control's seeds")
    ap.add_argument("--leaves", action="store_true", help="print every leaf's norms too")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # one process runs the program several times over: let freed blocks
    # merge, so the largest cell's runs fit one after another
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from perfbench import spec

    _, config, workload = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for i, seed in enumerate(args.seeds):
        first = i < args.control_seeds
        r = readings(config, workload, seed, device, first, args.faults if first else [], args.leaves)
        line = json.dumps({"workload": args.workload, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
