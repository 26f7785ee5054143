#!/usr/bin/env python3
"""Hypergradient norms of the JAX reference's asynchronous MDBO and MADSBO
baselines at their default steps, on the coefficient-tuning task at the
given feature widths, on the CPU:

    PYTHONPATH=src python tools/baseline_steps.py 200 500 1000 2000

Each width runs ``run_baseline_async`` with ``MDBOConfig()`` and
``MADSBOConfig()`` on ``coefficient_tuning_task(m=10, n=2000, p, c=20,
h=0.8, seed=0)``, ``ring(10)``, the geo fabric with lognormal stragglers
(``compute_s=0.05, sigma=0.8, seed=0``), T = 2, under the bounded-1 and the
sync policy, and prints one line a run: the round's hypergradient norms and
whether x stayed finite.  ``tests/test_torch_async.py`` holds the port's
runs to the reference's at p = 500.
"""

from __future__ import annotations

import argparse

import numpy as np

GEO = dict(profile="geo", straggler="lognormal", compute_s=0.05, sigma=0.8, seed=0)
RUNS = (("bounded", 1), ("sync", 0))


def reference_runs(p: int):
    import jax  # noqa: F401  (the reference's runtime)
    from repro.async_gossip.engine import run_baseline_async
    from repro.core import baselines as B
    from repro.core.topology import ring
    from repro.data.bilevel_tasks import coefficient_tuning_task
    from repro.net.fabric import make_fabric

    b = coefficient_tuning_task(m=10, n=2000, p=p, c=20, h=0.8, seed=0)
    topo = ring(10)
    for alg, cfg in (("mdbo", B.MDBOConfig()), ("madsbo", B.MADSBOConfig())):
        for policy, bound in RUNS:
            s, m = run_baseline_async(alg, b.problem, topo, cfg, b.x0, b.y0, 2, make_fabric(topo, **GEO),
                                      policy=policy, bound=bound)
            yield alg, policy, np.asarray(m["hypergrad_norm"]).tolist(), bool(np.isfinite(np.asarray(s.x)).all())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("widths", type=int, nargs="+")
    args = ap.parse_args()
    for p in args.widths:
        for alg, policy, norms, finite in reference_runs(p):
            print(f"p={p} {alg} {policy}: hypergrad_norm {norms}, x finite {finite}", flush=True)


if __name__ == "__main__":
    main()
