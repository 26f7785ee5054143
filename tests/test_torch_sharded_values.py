"""The sharded step's layouts against the plain step's values, in f32
within the golden tolerance (rtol 1e-4, atol 1e-6).

On a one-rank gloo mesh (1 x 1, in process), each layout's function on
DTensors against its plain version, value and gradient:

* the vocabulary-parallel cross-entropy (`sharded.vocab_parallel_nll`)
  against ``-log_softmax(logits)[label]``;
* the vocabulary-parallel embedding (`sharded.vocab_parallel_embedding`),
  both of its layouts (the table gathered over D's shards, and the
  tokens gathered onto them) against `transformer.embed_tokens`;
* the sharded attention (`attention.attn_apply` on DTensors, six heads)
  against the plain one;
* the decode cache's slot written by a ``where`` against the write by
  index.

On a gloo mesh of four CPU ranks (a subprocess, four processes), where
the splits are real: a train step's loss and every gradient, and a
decode step's logits and caches (atol 2e-5 there), against the plain
step on each rank:
six heads on a model axis of 4 (split by queries), of 2 (by heads, KV
heads split), eight heads with two KV heads on 4 (by heads, each
local head's KV head taken on the shard), a batch of 2 that a data axis
of 4 does not divide (the products' outputs Partial sums over it, the
attention split by queries there), and gemma2-smoke (tied embeddings,
sliding window, soft-caps) on 2 x 2.  About 45 s on one worker."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, release
from repro_torch.models import attention as A
from repro_torch.models import sharded as SH
from repro_torch.models import transformer as T

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def mesh():
    yield make_host_mesh(device="cpu")
    release()


def _close(got, want):
    got = got.full_tensor() if isinstance(got, DTensor) else got
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("batch", [Shard(1), Partial()], ids=["batch-sharded", "partial-sum"])
def test_vocab_parallel_cross_entropy_equals_the_plain_one(mesh, batch):
    """The logits sharded on the batch and the vocabulary, or a Partial sum
    over the data axis (a batch the axis does not divide, the head's D
    contracted on its shards), which the cross-entropy reduces first."""
    r = _rng()
    logits = torch.from_numpy(r.normal(size=(1, 3, 5, 37)).astype(np.float32) * 4)
    labels = torch.from_numpy(r.integers(0, 37, size=(1, 3, 5)))
    plain = logits.clone().requires_grad_()
    want = -torch.gather(torch.log_softmax(plain, -1), -1, labels[..., None])[..., 0]
    (gw,) = torch.autograd.grad((want * torch.arange(15.0).reshape(1, 3, 5)).sum(), plain)
    live = DTensor.from_local(logits.clone(), mesh, [batch, Shard(3)], run_check=False).requires_grad_()
    lab_pl = [batch if isinstance(batch, Shard) else Replicate(), Replicate()]
    with implicit_replication():
        got = SH.vocab_parallel_nll(live, DTensor.from_local(labels, mesh, lab_pl, run_check=False))
        assert tuple(got.placements) == tuple(lab_pl)
        (gg,) = torch.autograd.grad((got * torch.arange(15.0).reshape(1, 3, 5)).sum(), live)
    _close(got, want.detach())
    _close(gg, gw)


@pytest.mark.parametrize("n_tokens", [40, 6], ids=["table-gathered", "tokens-gathered"])
def test_vocab_parallel_embedding_equals_the_plain_lookup(mesh, n_tokens):
    """40 tokens against a 29-row shard gather the table over D's shards;
    6 tokens are gathered onto the table's D shards instead."""
    r = _rng(1)
    table = torch.from_numpy(r.normal(size=(1, 29, 8)).astype(np.float32))
    tokens = torch.from_numpy(r.integers(0, 29, size=(1, 2, n_tokens // 2)))
    plain = table.clone().requires_grad_()
    want = T.embed_tokens(plain, tokens)
    weight = torch.from_numpy(r.normal(size=want.shape).astype(np.float32))
    (gw,) = torch.autograd.grad((want * weight).sum(), plain)
    live = DTensor.from_local(table.clone(), mesh, [Shard(2), Shard(1)], run_check=False).requires_grad_()
    with implicit_replication():
        got = T.embed_tokens(live, DTensor.from_local(tokens, mesh, [Shard(1), Replicate()], run_check=False))
        (gg,) = torch.autograd.grad((got * weight).sum(), live)
    _close(got, want.detach())
    _close(gg, gw)
    assert tuple(gg.placements) == tuple(live.placements)


def test_sharded_attention_equals_the_plain_one(mesh):
    import dataclasses

    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True), num_heads=6, num_kv_heads=2, head_dim=32,
                              dtype=torch.float32)
    p, _ = A.attn_init(torch.Generator().manual_seed(0), cfg, "full")
    p = {k: v[None] for k, v in p.items()}
    r = _rng(2)
    x = torch.from_numpy(r.normal(size=(1, 2, 16, cfg.d_model)).astype(np.float32))
    pos = torch.arange(16, dtype=torch.int32).expand(2, 16)
    live = [t.clone().requires_grad_() for t in (x, *p.values())]
    want, (wk, _) = A.attn_apply(dict(zip(p, live[1:])), cfg, live[0], pos, q_chunk=8)
    gw = torch.autograd.grad(want.sum() + wk.sum(), live)
    rep = [Replicate(), Replicate()]
    dlive = [DTensor.from_local(t.clone(), mesh, rep, run_check=False).requires_grad_() for t in (x, *p.values())]
    dpos = DTensor.from_local(pos.contiguous(), mesh, rep, run_check=False)
    with implicit_replication():
        got, (gk, _) = A.attn_apply(dict(zip(p, dlive[1:])), cfg, dlive[0], dpos, q_chunk=8)
        gg = torch.autograd.grad(got.sum() + gk.sum(), dlive)
    _close(got, want.detach())
    _close(gk, wk.detach())
    for a, b in zip(gg, gw):
        _close(a, b)


def test_cache_slot_written_by_where_equals_the_write_by_index(mesh):
    r = _rng(3)
    cache = torch.from_numpy(r.normal(size=(1, 2, 8, 2, 4)).astype(np.float32))
    new = torch.from_numpy(r.normal(size=(1, 2, 1, 2, 4)).astype(np.float32))
    want = A._write_slot(cache, new, 5)
    with implicit_replication():
        got = A._write_slot(DTensor.from_local(cache, mesh, [Shard(1), Shard(2)], run_check=False),
                            DTensor.from_local(new, mesh, [Shard(1), Replicate()], run_check=False), 5)
    assert tuple(got.placements) == (Shard(1), Shard(2))
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(want[:, :, 5], new[:, :, 0]) and torch.equal(want[:, :, :5], cache[:, :, :5])


# --- four ranks ------------------------------------------------------------

SCRIPT = r"""
import dataclasses, json, socket, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MAMBA = dict(vocab_size=511, d_model=128)  # a vocabulary the model axis leaves whole
TRAIN = [("qwen2-7b", dict(num_heads=6, num_kv_heads=2, head_dim=32), (1, 4), 4),
         ("qwen2-7b", dict(num_heads=6, num_kv_heads=2, head_dim=32), (2, 2), 4),
         ("qwen2-7b", dict(num_heads=8, num_kv_heads=2, head_dim=32), (1, 4), 4),
         ("qwen2-7b", dict(num_heads=8, num_kv_heads=2, head_dim=32), (4, 1), 2),
         ("gemma2-27b", {}, (2, 2), 4),
         ("mixtral-8x7b", {}, (2, 2), 4),
         ("mixtral-8x7b", {}, (4, 1), 4),
         ("mamba2-2.7b", MAMBA, (2, 2), 4),
         ("jamba-1.5-large-398b", {}, (1, 4), 4)]
DECODE = [("qwen2-7b", dict(num_heads=6, num_kv_heads=2, head_dim=32), (1, 4), 4), ("gemma2-27b", {}, (2, 2), 4),
          ("qwen2-7b", dict(num_heads=8, num_kv_heads=2, head_dim=32), (4, 1), 1),
          ("mixtral-8x7b", {}, (4, 1), 16),
          ("mamba2-2.7b", MAMBA, (2, 2), 4),
          ("jamba-1.5-large-398b", {}, (2, 2), 4)]
RTOL = 1e-4
ATOL = {"train": 1e-6, "decode": 2e-5}


def worst(got, want, atol):
    from torch.distributed.tensor import DTensor
    got = got.full_tensor() if isinstance(got, DTensor) else got
    return float(((got.detach() - want.detach()).abs() / (atol + RTOL * want.detach().abs())).max())


def worker(rank, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves, tree_map, tree_unflatten
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partitioning import batch_sharding, tree_shardings

    def placed(tree, specs, mesh):
        sh = tree_shardings(specs, tree, mesh)
        return tree_map(lambda v, s: distribute_tensor(v, mesh, s.placements), tree, sh)

    out = {}
    for kind, cases in (("train", TRAIN), ("decode", DECODE)):
        for arch, over, shape, B in cases:
            cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, **over)
            params = T.init_lm_params(cfg, torch.Generator().manual_seed(0))
            g = torch.Generator().manual_seed(1)
            tokens = torch.randint(0, cfg.vocab_size, (B, 64), generator=g)
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            dp = placed(params, T.abstract_lm_params(cfg)[1], mesh)
            bat = lambda t: distribute_tensor(t, mesh, batch_sharding(mesh, t.shape, t.dim()).placements)
            DR.install_activation_constraint(mesh)
            try:
                if kind == "train":
                    labels = torch.roll(tokens, -1, 1)
                    live = [v.detach().clone().requires_grad_() for v in tree_leaves(params)]
                    loss = T.lm_loss(T.one_node(tree_unflatten(params, live)), cfg, tokens[None], labels[None])[0]
                    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
                    dlive = [v.detach().requires_grad_() for v in tree_leaves(dp)]
                    with implicit_replication():
                        dloss = T.lm_loss(T.one_node(tree_unflatten(dp, dlive)), cfg, bat(tokens).unsqueeze(0),
                                          bat(labels).unsqueeze(0))[0]
                        dgrads = torch.autograd.grad(dloss, dlive, allow_unused=True, materialize_grads=True)
                    pairs = [(dloss, loss)] + list(zip(dgrads, grads))
                else:
                    S = tokens.shape[1] // 2
                    _, caches = ST.make_prefill_step(cfg, max_len=2 * S)(params, {"tokens": tokens[:, :S]})
                    serve = ST.make_serve_step(cfg)
                    logits, new = serve(params, tokens[:, S], S, caches)
                    dc = placed(caches, T.cache_spec_tree(cfg), mesh)
                    with implicit_replication():
                        dlogits, dnew = serve(dp, bat(tokens[:, S]), S, dc)
                    pairs = [(dlogits, logits)] + list(zip(tree_leaves(dnew), tree_leaves(new)))
            finally:
                DR.uninstall_activation_constraint()
            out[f"{kind}/{arch}/{over.get('num_heads', cfg.num_heads)}x{over.get('num_kv_heads', cfg.num_kv_heads)}"
                f"/{shape[0]}x{shape[1]}/B{B}"] = max(worst(a, b, ATOL[kind]) for a, b in pairs)
    if rank == 0:
        q.put(out)
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    mp.start_processes(worker, args=(port, q), nprocs=4, join=True, start_method="spawn")
    print(json.dumps(q.get()))
"""

CASES = ["train/qwen2-7b/6x2/1x4/B4", "train/qwen2-7b/6x2/2x2/B4", "train/qwen2-7b/8x2/1x4/B4",
         "train/qwen2-7b/8x2/4x1/B2", "train/gemma2-27b/4x2/2x2/B4", "decode/qwen2-7b/6x2/1x4/B4",
         "decode/gemma2-27b/4x2/2x2/B4",
         "train/mixtral-8x7b/4x2/2x2/B4", "train/mixtral-8x7b/4x2/4x1/B4", "train/mamba2-2.7b/0x0/2x2/B4",
         "train/jamba-1.5-large-398b/4x2/1x4/B4", "decode/qwen2-7b/8x2/4x1/B1", "decode/mixtral-8x7b/4x2/4x1/B16",
         "decode/mamba2-2.7b/0x0/2x2/B4", "decode/jamba-1.5-large-398b/4x2/2x2/B4"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")] + env.get("PYTHONPATH", "").split(os.pathsep)
    )
    script = tmp_path_factory.mktemp("ranks") / "four_ranks.py"
    script.write_text(SCRIPT)
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES)
def test_four_rank_step_equals_the_plain_step(four_ranks, case):
    """The worst error of the loss and every gradient (a decode step's
    logits and every cache leaf) over its tolerance, atol + rtol |want|, is
    at most 1: rtol 1e-4, atol 1e-6 (a train step) or 2e-5 (decode, as
    the decode steps' card against host: its logits are O(1) sums whose
    partial sums the shards add in another order)."""
    assert four_ranks[case] <= 1.0, four_ranks
