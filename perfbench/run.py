"""Run one cell of the benchmark on the card this process starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result's JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card (or fewer than the cell asks for), without
the program (``src/repro_torch``), or where the process holds JAX or the
JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"the program under test is missing: {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from perfbench import harness, spec

    bench, config, workload = spec.load_cell(args.workload, ROOT)
    chips = spec.workload_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    harness.log(f"[device] {torch.cuda.get_device_name(device)}; {harness.power_limit()}")
    out = harness.run_cell(config, workload, args.seed, args.seconds, bool(args.trace), device,
                           spec.cell_metrics(bench, args.workload, bool(args.trace)), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window: the benchmark runs the port alone", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
