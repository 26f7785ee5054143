"""Checkpointing (``repro.checkpoint.io``'s counterpart): a tree of tensors in
the reference's file format, so either package loads the other's files.

The file is a msgpack map ``{b"leaves": [{b"dtype", b"shape", b"data"}, ...],
b"treedef": ...}``: each leaf's dtype name (``"float32"``, ``"bfloat16"``,
...), its shape and its bytes in C order, in the reference's flattening
order (sorted dict keys, lists and tuples in order, a NamedTuple's fields in
order; None holds no leaf), and the tree's structure as JAX prints it
(``PyTreeDef({'a': *, ...})``), for reading only: loading restores into the
structure of the tree it is given.  The map is compressed with zstd when
``zstandard`` imports, else with zlib (the same file name); `load_pytree`
tells the two apart by zstd's magic bytes.  Writes are atomic (tmp +
rename), and each checkpoint carries a JSON manifest beside it.

The card's machine has neither ``msgpack`` nor ``zstandard`` nor
``ml_dtypes``, so this module packs and unpacks the msgpack subset the
format uses itself (maps, arrays, bytes, str and unsigned integers, each in
msgpack's smallest encoding, as ``msgpack.packb`` writes them), and moves
bf16 leaves as their 16-bit patterns.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import torch

try:
    import zstandard as zstd
except ImportError:  # optional: fall back to zlib
    zstd = None

#: zstd frame header (RFC 8878): how `load_pytree` recognizes the codec
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_DTYPES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
    torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _compress(raw: bytes) -> bytes:
    if zstd is not None:
        return zstd.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstd is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstandard, which is not installed here — install the "
                "'checkpoint' extra to load it"
            )
        return zstd.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _header(out: bytearray, n: int, fix: int | None, fix_max: int, wide: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``wide`` ((code, struct format, limit), ...) whose limit holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in wide:
        if n < limit:
            out += struct.pack(">B" + fmt, code, n)
            return
    raise ValueError(f"a length of {n} does not fit msgpack")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, ((0xDE, "H", 1 << 16), (0xDF, "I", 1 << 32)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, ((0xDC, "H", 1 << 16), (0xDD, "I", 1 << 32)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _header(out, len(obj), None, 0, ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16), (0xC6, "I", 1 << 32)))
        out += obj
    elif isinstance(obj, str):
        b = obj.encode()
        _header(out, len(b), 0xA0, 32, ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16), (0xDB, "I", 1 << 32)))
        out += b
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 0x80:
            out.append(obj)
        else:
            _header(out, obj, None, 0, ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16), (0xCE, "I", 1 << 32),
                                        (0xCF, "Q", 1 << 64)))
    else:
        raise TypeError(f"the checkpoint format holds no {type(obj).__name__} ({obj!r})")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the subset the format uses."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf: memoryview, i: int):
    """(object, next offset) of the msgpack object at ``buf[i]``."""
    c = buf[i]
    i += 1

    def wide(fmt: str):
        n = struct.unpack_from(">" + fmt, buf, i)[0]
        return n, i + struct.calcsize(fmt)

    if c < 0x80:
        return c, i
    if 0x80 <= c <= 0x8F or c in (0xDE, 0xDF):
        n, i = (c & 0x0F, i) if c <= 0x8F else wide("H" if c == 0xDE else "I")
        out = {}
        for _ in range(n):
            k, i = _unpack(buf, i)
            out[k], i = _unpack(buf, i)
        return out, i
    if 0x90 <= c <= 0x9F or c in (0xDC, 0xDD):
        n, i = (c & 0x0F, i) if c <= 0x9F else wide("H" if c == 0xDC else "I")
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    if c in (0xC4, 0xC5, 0xC6):
        n, i = wide({0xC4: "B", 0xC5: "H", 0xC6: "I"}[c])
        return bytes(buf[i:i + n]), i + n
    if 0xA0 <= c <= 0xBF or c in (0xD9, 0xDA, 0xDB):
        n, i = (c & 0x1F, i) if c <= 0xBF else wide({0xD9: "B", 0xDA: "H", 0xDB: "I"}[c])
        return bytes(buf[i:i + n]).decode(), i + n
    if c in (0xCC, 0xCD, 0xCE, 0xCF):
        return wide({0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q"}[c])
    raise ValueError(f"msgpack code 0x{c:02x} is outside the checkpoint format")


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the subset the format uses."""
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the checkpoint's payload")
    return obj


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten(tree) -> tuple[list, str]:
    """(leaves, treedef string): the reference's flattening order and JAX's
    ``str(treedef)`` of the same structure."""
    leaves: list = []

    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return f"CustomNode(namedtuple[{type(t).__name__}], [" + ", ".join(walk(v) for v in t) + "])"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(like, leaves: list):
    """A tree shaped like ``like`` holding ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _pack_leaf(x) -> dict:
    """A tensor (or a Python int, stored as the reference's int32 scalar)."""
    t = torch.tensor(x, dtype=torch.int32) if isinstance(x, int) else x.detach()
    if t.dtype not in _DTYPES:
        raise TypeError(f"the checkpoint format holds no {t.dtype}")
    t = t.contiguous().cpu()
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # numpy has no bfloat16
    return {b"dtype": _DTYPES[t.dtype].encode(), b"shape": list(t.shape), b"data": bits.numpy().tobytes()}


def _unpack_leaf(d: dict) -> torch.Tensor:
    dtype, shape = _BY_NAME[d[b"dtype"].decode()], tuple(d[b"shape"])
    if not d[b"data"]:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(d[b"data"]), dtype=dtype).reshape(shape)


def _device(ref) -> torch.device:
    dev = ref.device if isinstance(ref, torch.Tensor) else torch.device("cpu")
    return torch.device("cpu") if dev.type == "meta" else dev


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def save_pytree(path: str, tree, step: int = 0, meta: dict | None = None) -> None:
    leaves, treedef = flatten(tree)
    payload = {b"leaves": [_pack_leaf(x) for x in leaves], b"treedef": treedef.encode()}
    comp = _compress(packb(payload))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)
    manifest = {"step": step, "leaves": len(leaves), "bytes": len(comp)}
    manifest.update(meta or {})
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (tensors, ``meta`` tensors, or
    Python ints for integer counters): each leaf at ``like``'s dtype and on
    its device (the CPU for a ``meta`` tensor)."""
    with open(path, "rb") as f:
        payload = unpackb(_decompress(f.read()))
    leaves_like, _ = flatten(like)
    stored = payload[b"leaves"]
    assert len(stored) == len(leaves_like), (len(stored), len(leaves_like))
    out = []
    for d, ref in zip(stored, leaves_like):
        t = _unpack_leaf(d)
        if isinstance(ref, int):
            out.append(int(t))
            continue
        assert tuple(t.shape) == tuple(ref.shape), (t.shape, ref.shape)
        out.append(t.to(device=_device(ref), dtype=ref.dtype))
    return unflatten(like, out)


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_"):
    if not os.path.isdir(ckpt_dir):
        return None
    files = [f for f in os.listdir(ckpt_dir) if f.startswith(prefix) and f.endswith(".msgpack.zst")]
    if not files:
        return None
    files.sort(key=lambda f: int(f[len(prefix):].split(".")[0]))
    return os.path.join(ckpt_dir, files[-1])


def checkpoint_path(ckpt_dir: str, step: int, prefix: str = "ckpt_") -> str:
    return os.path.join(ckpt_dir, f"{prefix}{step:08d}.msgpack.zst")
