"""Coefficient tuning (arXiv:2410.14115 §6.1) as a benchmark family: the
program's task from its own builder, the plain reference from the seed,
and the round's model FLOPs.

The configuration file gives the task's sizes (documents, features,
classes, and the documents each node holds of each split), the nodes,
their graph, the label skew and the C²DFB step sizes; the workload file
the compressor and K.
"""

from __future__ import annotations

import dataclasses

from perfbench.reference import c2dfb as plain
from perfbench.spec import c2dfb_settings
from perfbench.reference import coef_task

STORAGE = "float32"
# the control: the program's own lower-precision path, TF32 products
CONTROL = "program_tf32"
# the upper level's leaves, whose change the check also holds by its
# direction (`harness.compare`'s ``step_dir_gap``): x moves here
STEP_TREES = ("x/",)


def program(config: dict, workload: dict, seed: int, device) -> dict:
    """The program's problem, graph, C²DFB settings and start, built by its
    own task builder from the seed."""
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import make_topology
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task

    t = config["task"]
    bundle = coefficient_tuning_task(m=config["nodes"], n=t["n_documents"], p=t["n_features"], c=t["n_classes"],
                                     h=t["label_skew"], seed=seed, device=device)
    p = bundle.problem
    problem = dataclasses.replace(p, data_f=_first_rows(p.data_f, t["val_per_node"]),
                                  data_g=_first_rows(p.data_g, t["train_per_node"]))
    return {"problem": problem, "topo": make_topology(config["topology"], config["nodes"]),
            "cfg": C2DFBConfig(**c2dfb_settings(config, workload)), "x0": bundle.x0, "y0": bundle.y0}


def _first_rows(shard: dict, n: int) -> dict:
    """Each node's first ``n`` documents: every seed then does the same
    work (the builder cuts the shards to the smallest node's, which the
    seed moves)."""
    if shard["a"].shape[1] < n:
        raise ValueError(f"a node holds {shard['a'].shape[1]} documents, fewer than the {n} the cell takes")
    return {k: v[:, :n].contiguous() for k, v in shard.items()}


def reference(config: dict, workload: dict, seed: int, device, precision: plain.Precision):
    """(the plain rounds, x0, y0), every input drawn again from the seed."""
    t, m = config["task"], config["nodes"]
    val, train = coef_task.shards(t["n_documents"], t["n_features"], t["n_classes"], m, t["label_skew"], seed,
                                  device)
    val, train = _first_rows(val, t["val_per_node"]), _first_rows(train, t["train_per_node"])
    x0, y0 = coef_task.initial_point(t["n_features"], t["n_classes"], m, seed, device)
    oracles = coef_task.Oracles(val, train, t["n_classes"], precision)
    return oracles, x0, y0


def model_flops(config: dict, workload: dict, problem) -> float:
    """The products one round's oracle calls need, all nodes: the y loop's
    K + 1 gradients of h = f + lam g (each a logits product and its
    transpose on the validation and on the training shard), the z loop's
    K + 1 gradients of g (on the training shard); the three x-partials
    need no product (f does not read x, g reads it in its ridge only).
    2 n p c a product; the shard sizes are the data's."""
    m, n_f, p = problem.data_f["a"].shape
    n_g = problem.data_g["a"].shape[1]
    c = config["task"]["n_classes"]
    calls = c2dfb_settings(config, workload)["K"] + 1
    return float(m * calls * (4 * (n_f + n_g) * p * c + 4 * n_g * p * c))


def mixing_flops(config: dict, workload: dict, problem) -> float:
    """The round's (W - I) X products: x and s_x once, the two references
    of each inner step (2 K of each loop), 2 m^2 d each."""
    m, _, p = problem.data_f["a"].shape
    c, K = config["task"]["n_classes"], c2dfb_settings(config, workload)["K"]
    return float(2 * m * m * (2 * p + 4 * K * p * c))
