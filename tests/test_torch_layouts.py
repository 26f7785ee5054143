"""Where the dry run's sharded step keeps its large tensors, on a fake
8-rank (data 2, model 4) mesh at smoke size:

* the cross-entropy's per-chunk logits stay sharded on the vocabulary
  over "model" (each device holds V / 4 of each chunk's columns);
* a train step redistributes neither ``lm_head`` nor ``embed`` off their
  vocabulary shards, nor any other tensor of the vocabulary's width;
* a decode step gathers no cache leaf off its ``cache_seq`` shards;
* six heads on a model axis of four run their attention on shards: the
  step's FLOPs per device at most 1.05 x the unsharded step's / 8.

Every DTensor redistribution, explicit or made by DTensor's operator
dispatch, goes through ``redistribute_local_tensor``; the tests record
each one's global shape and placements there.  The configs are smoke
configs with a vocabulary of 1,000 (a width no other dimension has) and a
decode cache of 96 slots.  About 15 s on one worker."""

import dataclasses

import pytest
from torch.distributed.tensor import Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import InputShape, get_config, input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as PM
from repro_torch.models import layers as L
from repro_torch.models import steps as PS
from repro_torch.models.transformer import abstract_lm_params

V = 1000
S_CACHE = 96
B = 8


def _cfg(**over):
    return dataclasses.replace(get_config("qwen2-7b", smoke=True), vocab_size=V, **over)


class Redistributions:
    """Records (global shape, placements before, placements after) of every
    DTensor redistribution while active."""

    def __init__(self, monkeypatch):
        from torch.distributed.tensor import _api, _dispatch, _redistribute

        self.seen = []
        orig = _redistribute.redistribute_local_tensor

        def record(local, current, target, *args, **kwargs):
            self.seen.append((tuple(current.shape), tuple(current.placements), tuple(target.placements)))
            return orig(local, current, target, *args, **kwargs)

        for mod in (_api, _dispatch, _redistribute):
            monkeypatch.setattr(mod, "redistribute_local_tensor", record)

    def unsharded(self, width: int, tail: tuple = ()) -> list:
        """The redistributions that take a dimension of ``width`` off its
        shards (one followed by the dimensions ``tail``, when given)."""
        return [(shape, a, b) for shape, a, b in self.seen
                for p, q in zip(a, b)
                if isinstance(p, Shard) and shape[p.dim] == width and shape[p.dim + 1:][:len(tail)] == tail
                and not (isinstance(q, Shard) and q.dim == p.dim)]


@pytest.fixture(scope="module")
def mesh():
    yield PM.make_fake_mesh((2, 4), ("data", "model"), "cpu")
    PM.release()


def _run(mesh, monkeypatch, cfg, shape: InputShape) -> dict:
    monkeypatch.setattr(D, "get_config", lambda arch, smoke=False: cfg)
    D.install_activation_constraint(mesh)
    try:
        case = D.build_case("qwen2-7b", shape, mesh)
        make, mode = D.fake_locals("cpu")
        with mode, D.host_index_math():
            return D.run_case(case, "cpu", make)
    finally:
        D.uninstall_activation_constraint()


def test_cross_entropy_logits_stay_sharded_on_the_vocabulary(mesh, monkeypatch):
    seen = []
    orig = L.vocab_parallel_nll

    def spy(logits, labels):
        seen.append((tuple(logits.placements), logits.to_local().shape[-1]))
        return orig(logits, labels)

    monkeypatch.setattr(L, "vocab_parallel_nll", spy)
    _run(mesh, monkeypatch, _cfg(), InputShape("t", 64, B, "train"))
    assert seen, "the sharded step took the plain cross-entropy"
    for placements, local_v in seen:
        assert placements[1] == Shard(3) and local_v == V // 4, (placements, local_v)


def test_train_step_keeps_the_vocabulary_on_its_shards(mesh, monkeypatch):
    red = Redistributions(monkeypatch)
    res = _run(mesh, monkeypatch, _cfg(), InputShape("t", 64, B, "train"))
    assert red.seen, "no redistribution recorded: the hook is not on DTensor's path"
    assert red.unsharded(V) == []
    assert res["collectives"]["total_bytes"] > 0


def test_tied_embedding_train_step_keeps_the_vocabulary_on_its_shards(mesh, monkeypatch):
    red = Redistributions(monkeypatch)
    cfg = dataclasses.replace(get_config("gemma2-27b", smoke=True), vocab_size=V)
    _run(mesh, monkeypatch, cfg, InputShape("t", 64, B, "train"))
    assert red.unsharded(V) == []


def test_decode_step_gathers_no_cache_leaf(mesh, monkeypatch):
    """No tensor shaped as a cache leaf, (..., slots, KV, hd), leaves its
    slots' shards (the scores, (..., 1, slots), are gathered for their
    softmax: B x H x slots, not a cache)."""
    red = Redistributions(monkeypatch)
    cfg = _cfg()
    res = _run(mesh, monkeypatch, cfg, InputShape("d", S_CACHE, B, "decode"))
    assert red.unsharded(S_CACHE, (cfg.num_kv_heads, cfg.head_dim)) == []
    assert res["collectives"]["total_bytes"] > 0


def _unsharded_flops(cfg, shape: InputShape) -> int:
    params = abstract_lm_params(cfg)[0]
    specs = input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        step, opt = PS.make_train_step(cfg, "adamw")
        step(params, opt.init(params), specs)
    return counter.get_total_flops()


@pytest.mark.parametrize("heads,kv", [(6, 2), (6, 6), (8, 2)], ids=["6-on-4-gqa", "6-on-4-mha", "8-on-4-kv2"])
def test_heads_the_model_axis_does_not_divide_run_on_shards(mesh, monkeypatch, heads, kv):
    cfg = _cfg(num_heads=heads, num_kv_heads=kv, head_dim=64)
    shape = InputShape("t", 64, B, "train")
    res = _run(mesh, monkeypatch, cfg, shape)
    whole = _unsharded_flops(cfg, shape)
    assert res["flops"] <= 1.05 * whole / 8, (res["flops"], whole / 8)
