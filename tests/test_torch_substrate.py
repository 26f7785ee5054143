"""The port's optimizers, schedules, checkpoints and token streams
(``repro_torch.optim``, ``repro_torch.checkpoint``, ``repro_torch.data``)
against the live reference.

* ``tests/test_substrate.py``'s nine cases on the port: SGD-M and AdamW
  converge, bf16 moments, clipping, the cosine schedule's shape, the
  checkpoint round trip, the token streams and the label skew;
* parity: ``sgdm_update`` and ``adamw_update`` (several steps, f32 and bf16
  parameters) fed the reference's gradients give the reference's
  parameters and moments within the golden tolerance (rtol 1e-4, atol
  1e-6; bf16 parameters within one bf16 step, the rounding of the final
  cast); ``clip_by_global_norm``; ``linear_warmup`` equal over 0..T and
  ``cosine_schedule`` within 2 f32 ulps (XLA's f32 cosine lies within an
  ulp of the correctly rounded one the port takes, and the sum rounds once
  more);
* checkpoints: the port's packer gives ``msgpack.packb``'s bytes and the
  reference's payload byte for byte (f32, bf16 and int32 leaves, nested
  dicts, lists, an optimizer state with its None); a file written by
  either package loads in the other bit for bit, under zstd and under
  zlib; ``latest_checkpoint`` and the manifest.

About 5 s on one worker."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

msgpack = pytest.importorskip("msgpack")

from repro import optim as J  # noqa: E402
from repro.checkpoint import io as JIO  # noqa: E402
from repro_torch import optim as P  # noqa: E402
from repro_torch.checkpoint import io as PIO  # noqa: E402
from repro_torch.checkpoint.io import checkpoint_path, latest_checkpoint, load_pytree, save_pytree  # noqa: E402
from repro_torch.core.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.core.types import tree_leaves  # noqa: E402
from repro_torch.data.partition import label_skew_partition  # noqa: E402
from repro_torch.data.synthetic import TokenStream, node_streams  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-6)
BF16_STEP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs on several
    workers sharing the machine's cores, where torch's own thread pool
    (one thread a core) oversubscribes them and its small operators run
    several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad_problem():
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(32,)).astype(np.float32))

    def grad(p):
        return {"w": 2.0 * (p["w"] - target)}

    return grad, {"w": torch.zeros((32,))}, target


# ---------------------------------------------------------------- tests/test_substrate.py on the port


def test_sgdm_converges():
    grad, params, target = _quad_problem()
    state = P.sgdm_init(params)
    for _ in range(200):
        params, state = P.sgdm_update(grad(params), state, params, lr=0.05)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-3)


def test_adamw_converges():
    grad, params, target = _quad_problem()
    state = P.adamw_init(params)
    for _ in range(500):
        params, state = P.adamw_update(grad(params), state, params, lr=0.05, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_adamw_bf16_moments():
    grad, params, _ = _quad_problem()
    state = P.adamw_init(params, moment_dtype=torch.bfloat16)
    params2, state2 = P.adamw_update(grad(params), state, params, lr=0.05)
    assert state2.m["w"].dtype == torch.bfloat16
    assert torch.isfinite(params2["w"]).all()


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = P.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 10.0 * np.sqrt(10)) < 1e-3
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_cosine_schedule_shape():
    lrs = [P.cosine_schedule(s, 1.0, 100, warmup_steps=10) for s in range(100)]
    assert lrs[0] < 0.2
    assert max(lrs) <= 1.0 + 1e-6
    assert lrs[-1] < 0.2


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((5,), dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }
    path = checkpoint_path(str(tmp_path), 7)
    save_pytree(path, tree, step=7, meta={"arch": "test"})
    like = {"a": tree["a"].to("meta"), "b": {"c": tree["b"]["c"].to("meta")}, "step": tree["step"].to("meta")}
    restored = load_pytree(path, like)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy())
    assert latest_checkpoint(str(tmp_path)) == path
    assert os.path.exists(path + ".json")


def test_token_stream_learnable_and_deterministic():
    s1 = TokenStream(vocab_size=64, seq_len=32, batch_size=4, seed=1)
    s2 = TokenStream(vocab_size=64, seq_len=32, batch_size=4, seed=1)
    b1, b2 = s1.next_batch(), s2.next_batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 32)
    assert b1["tokens"].min() >= 0 and b1["tokens"].max() < 64
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])  # labels are next tokens


def test_node_streams_heterogeneous():
    streams = node_streams(4, 64, 128, 8, seed=0)
    batches = [s.next_batch()["tokens"] for s in streams]
    assert not np.array_equal(batches[0], batches[1])
    assert len({s._shift for s in streams}) > 1


def test_label_skew_extremes():
    labels = np.repeat(np.arange(4), 100)
    iid = label_skew_partition(labels, 4, h=0.0, seed=0)
    skew = label_skew_partition(labels, 4, h=1.0, seed=0)

    def homefrac(shards):
        return np.mean([np.mean(labels[s] == i) for i, s in enumerate(shards)])

    assert homefrac(skew) > 0.9
    assert homefrac(iid) < 0.5


# ---------------------------------------------------------------- parity


def _tree(seed, dtype=jnp.float32):
    r = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(r.normal(size=(6, 5)), dtype),
        "blocks": [{"b": jnp.asarray(r.normal(size=(7,)), dtype)}, {"b": jnp.asarray(r.normal(size=(7,)), dtype)}],
    }


def _grads(seed):
    """Gradients with entries of both signs and magnitudes from 1e-4 to 10."""
    r = np.random.default_rng(seed)
    t = _tree(seed)
    return jax.tree.map(lambda v: jnp.asarray(r.normal(size=v.shape) * 10.0 ** r.uniform(-4, 1, size=v.shape),
                                              jnp.float32), t)


def _close(got, want, bf16=False):
    for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        if bf16:
            # both round the same f32 value once; a last-place difference of
            # the f32 arithmetic may flip that rounding by one bf16 step
            np.testing.assert_allclose(to_numpy(a), w, rtol=BF16_STEP, atol=0)
        else:
            np.testing.assert_allclose(to_numpy(a), w, **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_updates_match_the_reference(name, dtype):
    """Four updates (lr 0.05, weight decay on for AdamW) from the same
    parameters and gradients: parameters and moments.

    AdamW's first step is nearly sign(g): an entry whose gradient lies
    within the two packages' rounding of zero may move by up to 2 lr apart
    (none does here, the gradients being well away from zero)."""
    jdt, bf16 = (jnp.bfloat16, True) if dtype == "bf16" else (jnp.float32, False)
    jp = _tree(0, jdt)
    pp = from_numpy(jp)
    jopt, popt = J.make_optimizer(name), P.make_optimizer(name)
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(4):
        g = jax.tree.map(lambda v: v.astype(jdt), _grads(step + 1))
        jp, js = jopt.update(g, js, jp, 0.05)
        pp, ps = popt.update(from_numpy(g), ps, pp, 0.05)
        _close(pp, jp, bf16)
        _close(ps.m, js.m)
        if name == "adamw":
            _close(ps.v, js.v)
        else:
            assert ps.v is None and js.v is None
        assert ps.step == int(js.step) == step + 1


def test_clip_matches_the_reference():
    for max_norm in (1.0, 1e3):  # clipping, and a scale of 1
        g = _grads(5)
        jc, jn = J.clip_by_global_norm(g, max_norm)
        pc, pn = P.clip_by_global_norm(from_numpy(g), max_norm)
        np.testing.assert_allclose(float(pn), float(jn), **TOL)
        _close(pc, jc)
    gb = jax.tree.map(lambda v: v.astype(jnp.bfloat16), _grads(6))
    jc, _ = J.clip_by_global_norm(gb, 1.0)
    pc, _ = P.clip_by_global_norm(from_numpy(gb), 1.0)
    _close(pc, jc, bf16=True)


def test_schedules_match_the_reference():
    for total, warm, lr in ((100, 10, 1.0), (100, 0, 3e-4), (1000, 37, 0.02), (7, 3, 0.5)):
        for s in range(total + 3):
            assert P.linear_warmup(s, lr, warm) == float(J.linear_warmup(jnp.int32(s), lr, warm))
            a = np.float32(P.cosine_schedule(s, lr, total, warmup_steps=warm))
            b = np.asarray(J.cosine_schedule(jnp.int32(s), lr, total, warmup_steps=warm), np.float32)
            assert abs(int(a.view(np.int32)) - int(b.view(np.int32))) <= 2, (total, warm, s, a, b)


# ---------------------------------------------------------------- checkpoints


def _ref_tree():
    r = np.random.default_rng(3)
    return {
        "a": jnp.asarray(r.normal(size=(30, 17)), jnp.float32),
        "b": {"c": jnp.asarray(r.normal(size=(300, 70)), jnp.bfloat16), "l": [jnp.int32(7), jnp.arange(5)]},
        "empty": jnp.zeros((0, 3), jnp.float32),
        "opt": J.sgdm_init({"w": jnp.ones((4,), jnp.float32)}),
    }


def _port_like(tree):
    return from_numpy(tree)


def test_packer_gives_msgpacks_bytes_and_the_references_payload():
    jt = _ref_tree()
    pt = _port_like(jt)
    leaves, treedef = PIO.flatten(pt)
    jl, jdef = jax.tree.flatten(jt)
    assert treedef == str(jdef)
    payload = {b"leaves": [PIO._pack_leaf(x) for x in leaves], b"treedef": treedef.encode()}
    raw = PIO.packb(payload)
    assert raw == msgpack.packb(payload)
    assert raw == msgpack.packb({b"leaves": [JIO._pack_leaf(x) for x in jl], b"treedef": str(jdef).encode()})
    assert PIO.unpackb(raw) == msgpack.unpackb(raw)
    big = {b"n": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32], b"s": "x" * 40, b"t": "y" * 300,
           b"d": bytes(70000), b"l": list(range(20))}
    assert PIO.packb(big) == msgpack.packb(big)
    assert PIO.unpackb(PIO.packb(big)) == big


def _same_bits(port_tree, ref_tree):
    got, want = PIO.flatten(port_tree)[0], jax.tree.leaves(ref_tree)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        w = np.asarray(w)
        if isinstance(a, int):  # an optimizer state's step counter
            assert w.dtype == np.int32 and a == int(w)
        elif w.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert a.numpy().dtype == w.dtype
            np.testing.assert_array_equal(a.numpy(), w)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_checkpoints_cross_load_bit_for_bit(tmp_path, monkeypatch, codec):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setattr(JIO, "zstd", None)
        monkeypatch.setattr(PIO, "zstd", None)
    jt = _ref_tree()
    pt = _port_like(jt)
    port_file, ref_file = str(tmp_path / "port.msgpack.zst"), str(tmp_path / "ref.msgpack.zst")
    save_pytree(port_file, pt, step=3)
    JIO.save_pytree(ref_file, jt, step=3)
    with open(port_file, "rb") as f, open(ref_file, "rb") as g:
        a, b = f.read(), g.read()
    assert (a[:4] == PIO._ZSTD_MAGIC) == (codec == "zstd")
    assert a == b  # the same bytes on disk
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jt)
    _same_bits(from_numpy(JIO.load_pytree(port_file, like)), jt)
    restored = load_pytree(ref_file, pt)
    _same_bits(restored, jt)
    assert restored["opt"].v is None and restored["opt"].step == 0


def test_latest_checkpoint_and_manifest(tmp_path):
    d = str(tmp_path)
    assert latest_checkpoint(d) is None and latest_checkpoint(str(tmp_path / "none")) is None
    for step in (2, 10, 7):
        save_pytree(checkpoint_path(d, step), {"w": torch.full((3,), float(step))}, step=step, meta={"arch": "x"})
    assert latest_checkpoint(d) == checkpoint_path(d, 10) == JIO.checkpoint_path(d, 10)
    with open(checkpoint_path(d, 10) + ".json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 10 and manifest["leaves"] == 1 and manifest["arch"] == "x"
    assert manifest["bytes"] == os.path.getsize(checkpoint_path(d, 10))
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
    assert JIO.latest_checkpoint(d) == latest_checkpoint(d)
