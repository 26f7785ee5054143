"""A dense decoder LM as the LM bilevel task (the backbone the upper level
x, the head the lower level y; one node a data shard), as a benchmark
family: the program's problem from its own LM bilevel builder on the
benchmark's weights and tokens, the plain reference, and the round's
model FLOPs.

The configuration file holds the model's published sizes (the
``config.json`` keys), the layers kept, and the C²DFB step sizes; the
workload file the nodes, their graph, the tokens a node (batch and
length), the compressor and K.

The weights are drawn by the benchmark, not the program: one model, every
matrix and the embedding N(0, initializer_range) and every norm scale 1,
from a ``torch.Generator`` on the run's device seeded with the seed, in
one draw; each node holds a copy.  The reference draws them again.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import traffic
from perfbench.reference import c2dfb as plain
from perfbench.spec import c2dfb_settings
from perfbench.reference import dense_lm

STORAGE = "bfloat16"
RIDGE = 1e-4  # the LM bilevel task's ridge on the head
# the control: the reference with its state, gradients and model products
# in float8 (e4m3, one scale a tensor), the step below bfloat16
CONTROL = plain.Precision(storage="float8", products="float8")


def shapes(config: dict) -> dict:
    """One model's leaves, by path: the layers stacked on a leading axis."""
    D, F, V, L = (config["model"][k] for k in ("hidden_size", "intermediate_size", "vocab_size",
                                                  "num_hidden_layers"))
    H, KV = config["model"]["num_attention_heads"], config["model"]["num_key_value_heads"]
    hd = D // H
    return {
        "embed": (V, D),
        "blocks.0.norm1": (L, D),
        "blocks.0.attn.wq": (L, D, H * hd),
        "blocks.0.attn.wk": (L, D, KV * hd),
        "blocks.0.attn.wv": (L, D, KV * hd),
        "blocks.0.attn.wo": (L, H * hd, D),
        "blocks.0.norm2": (L, D),
        "blocks.0.mlp.wi": (L, D, F),
        "blocks.0.mlp.wg": (L, D, F),
        "blocks.0.mlp.wo": (L, F, D),
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def weights(config: dict, m: int, seed: int, device) -> dict:
    """Every node's copy of one model, bfloat16, by path (node axis first)."""
    std = config["model"]["initializer_range"]
    shp = shapes(config)
    mats = [k for k in sorted(shp) if "norm" not in k]
    sizes = [int(np.prod(shp[k])) for k in mats]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(std).to(torch.bfloat16)
    out = {}
    for k, part in zip(mats, torch.split(draw, sizes)):
        out[k] = part.reshape(shp[k]).unsqueeze(0).expand(m, *shp[k]).contiguous()
    del draw
    for k in shp:
        if "norm" in k:
            out[k] = torch.ones((m, *shp[k]), dtype=torch.bfloat16, device=device)
    return out


def nest(flat: dict) -> dict:
    """A flat path dict as the program's nested tree (a level whose keys
    are all numbers is a list)."""
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return _lists(tree)


def _lists(tree):
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def model_config(config: dict):
    """The program's ModelConfig for the file's sizes."""
    from repro_torch.configs.base import ModelConfig

    mdl = config["model"]
    return ModelConfig(
        name=config["name"], arch_type="dense", num_layers=mdl["num_hidden_layers"], d_model=mdl["hidden_size"],
        num_heads=mdl["num_attention_heads"], num_kv_heads=mdl["num_key_value_heads"],
        head_dim=mdl["hidden_size"] // mdl["num_attention_heads"], d_ff=mdl["intermediate_size"],
        vocab_size=mdl["vocab_size"], pattern=("full",), mlp_type="swiglu", rope_theta=mdl["rope_theta"],
        norm_eps=mdl["rms_norm_eps"], dtype=torch.bfloat16, tie_embeddings=mdl["tie_word_embeddings"],
    )


def _tokens(config: dict, workload: dict, seed: int, device) -> dict:
    sh = traffic.token_shards(config["model"]["vocab_size"], workload["tokens"], workload["nodes"], seed)
    return {lvl: {k: torch.from_numpy(v).to(device) for k, v in d.items()} for lvl, d in sh.items()}


def program(config: dict, workload: dict, seed: int, device) -> dict:
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.lm_bilevel import make_lm_bilevel, split_params
    from repro_torch.core.topology import make_topology
    from repro_torch.models.transformer import abstract_lm_params

    cfg, m = model_config(config), workload["nodes"]
    params = nest(weights(config, m, seed, device))
    want, _ = abstract_lm_params(cfg)
    _same_layout(params, want, m)
    x0, y0 = split_params(params)
    data = _tokens(config, workload, seed, device)
    return {"problem": make_lm_bilevel(cfg, data["train"], data["val"], m, ridge=RIDGE),
            "topo": make_topology(workload["topology"], m),
            "cfg": C2DFBConfig(**c2dfb_settings(config, workload)), "x0": x0, "y0": y0}


def _same_layout(params, want, m: int, path: str = "") -> None:
    if isinstance(want, dict) or isinstance(want, list):
        keys = sorted(want) if isinstance(want, dict) else range(len(want))
        got = sorted(params) if isinstance(params, dict) else range(len(params))
        if list(keys) != list(got):
            raise ValueError(f"the program's parameters at {path or 'the root'} are {list(keys)}, the benchmark's "
                             f"{list(got)}")
        for k in keys:
            _same_layout(params[k], want[k], m, f"{path}.{k}")
    elif tuple(params.shape) != (m, *want.shape) or params.dtype != want.dtype:
        raise ValueError(f"{path}: the program holds {tuple(want.shape)} {want.dtype}, the benchmark draws "
                         f"{tuple(params.shape[1:])} {params.dtype}")


def reference(config: dict, workload: dict, seed: int, device, precision: plain.Precision):
    m = workload["nodes"]
    w = weights(config, m, seed, device)
    y0 = {k: w.pop(k) for k in dense_lm.HEAD}
    data = _tokens(config, workload, seed, device)
    data = {lvl: {k: v.long() for k, v in d.items()} for lvl, d in data.items()}
    oracles = dense_lm.Oracles(config["model"], data["val"], data["train"], RIDGE, precision)
    return oracles, w, y0


def model_flops(config: dict, workload: dict, problem=None) -> float:
    """The products one round's oracle calls need, all nodes, with no
    recompute and no elementwise work.  Within a round x is fixed, so the
    layers' forward on each shard (validation, training) is needed once;
    each of the 2 (K + 1) y-gradients needs the head's forward and its
    weight gradient on its shards (h reads both, g the training shard);
    each of the three x-partials needs the head's forward, the gradient
    through the head and the layers' backward (twice their forward)."""
    mdl, tr = config["model"], workload["tokens"]
    D, F, V, L = mdl["hidden_size"], mdl["intermediate_size"], mdl["vocab_size"], mdl["num_hidden_layers"]
    H, KV = mdl["num_attention_heads"], mdl["num_key_value_heads"]
    hd = D // H
    B, S = tr["batch"], tr["seq_len"]
    T = B * S
    layer = 2 * T * D * (H * hd + 2 * KV * hd) + 2 * T * H * hd * D + 3 * 2 * T * D * F + 2 * 2 * B * H * S * S * hd
    layers = L * layer
    head = 2 * T * D * V
    calls = c2dfb_settings(config, workload)["K"] + 1
    y_grads = calls * (2 * 2 * head) + calls * (2 * head)
    x_parts = 3 * (head + head + 2 * layers)
    return float(workload["nodes"] * (2 * layers + y_grads + x_parts))


def mixing_flops(config: dict, workload: dict, problem=None) -> float:
    m, K = workload["nodes"], c2dfb_settings(config, workload)["K"]
    shp = shapes(config)
    dy = sum(int(np.prod(shp[k])) for k in dense_lm.HEAD)
    dx = sum(int(np.prod(v)) for k, v in shp.items()) - dy
    return float(2 * m * m * (2 * dx + 4 * K * dy))
