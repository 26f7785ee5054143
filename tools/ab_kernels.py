#!/usr/bin/env python3
"""Time an earlier build of the port's top-k, pack, unpack and quantizer
kernels against the current one on one CUDA card, in turns, and dump both
builds' SASS.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C old/
    python3 tools/ab_kernels.py old/src/repro_torch/kernels/csrc --out DIR

The earlier sources must export the tile entry points of the current ones
(``block_topk_f32``, ``block_topk_bf16``, ``pack_sparse_blocks_f32``,
``unpack_sparse_blocks_f32``, ``quantize_f32``, ``quantize_bf16``, with the
signatures of ``_build.SIGNATURES``).  Both builds use the port's nvcc
flags.  Each build is first checked bit for bit against the plain versions
at the main path's shapes (block top-k f32 and bf16 at (19,850, 1,024), k =
205; pack at (1,985, 1,024) of its output; the unpack tile at the fused
exchange's stacked shape, (19,850, 256) records of B1's output back to
(19,850, 1,024); the quantizer f32 and bf16 at (19,850, 1,024), bits 4).
Then each kernel is timed in the order earlier, current, current, earlier,
as chip_smoke.py times a kernel (device time by torch.profiler, call time
by CUDA events); the current quantizer's leaf entry point (the (10,
2,032,620) leaf read in place) is timed in the current turns, and the
unpack's leaf entry point (those records onto a (10, 2,032,620) f32 base)
in the turns of every build that exports it.  The SASS of both libraries
goes to DIR, with each kernel's instruction count by opcode, in all and in
each loop, printed for the instances the main path launches; for the
quantizer also the instructions a coded value (one FRND, its floor, a
value: a loop's instructions over its FRND, or in the unrolled kernel the
span between a code path's first and last FRND).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pack_residuals import (  # noqa: E402
    pack_sparse_blocks_ref,
    padded_k,
    unpack_sparse_blocks_into_ref,
    unpack_sparse_blocks_ref,
)
from repro_torch.kernels.ref import block_topk_ref, quantize_ref  # noqa: E402

SOURCES = ("topk_compress", "pack_residuals", "quantize")


def build(csrc: Path, out: Path) -> dict[str, ctypes.CDLL]:
    """nvcc every source of ``csrc`` in parallel into ``out``; load each."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {n: subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{n}.so"),
                                  str(csrc / f"{n}.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n in SOURCES}
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {csrc / n}.cu failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{n}.so"))
        for fn, argtypes in _build.SIGNATURES[n].items():
            if not hasattr(lib, fn):  # an entry point the earlier sources lack
                continue
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[n] = lib
    return libs


def sass_counts(lib: Path, dump: Path) -> dict[str, tuple[collections.Counter, list[collections.Counter], list[int]]]:
    """{kernel: (opcode counts of the whole kernel, of each loop, the
    positions of its FRND instructions)} from cuobjdump -sass, whose text
    goes to ``dump``.  A loop is the span from the target of a backward
    branch to that branch: the first is the bisection round of block top-k
    (its 24 rounds are not unrolled)."""
    text = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    dump.write_text(text)
    funcs, cur = {}, None
    for line in text.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            cur = funcs.setdefault(m.group(1), [])
        elif cur is not None and (m := re.search(r"/\*([0-9a-f]{4})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)", line)):
            cur.append((int(m.group(1), 16), m.group(3).split(".")[0], m.group(4)))
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, op, args in ins:
            tgt = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
            if tgt and int(tgt.group(1), 16) < addr:
                loops.append(collections.Counter(o for a, o, _ in ins if int(tgt.group(1), 16) <= a <= addr))
        frnd = [i for i, (_, op, _) in enumerate(ins) if op == "FRND"]
        out[fn] = (collections.Counter(op for _, op, _ in ins), loops, frnd)
    return out


def per_value(frnd: list[int]) -> list[float]:
    """The quantizer codes a value with one FRND (its floor).  The current
    kernel unrolls a lane's V values twice, once in each code path (finite
    scale first, then NaN or inf): per path, the instructions from its first
    floor to its last over V - 1, the instructions a coded value there."""
    half = len(frnd) // 2
    if half < 2:
        return []
    return [(frnd[half - 1] - frnd[0]) / (half - 1), (frnd[-1] - frnd[half]) / (half - 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_csrc", type=Path)
    ap.add_argument("--out", type=Path, required=True, help="directory for the SASS dumps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device available", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    print(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    args.out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"earlier": build(args.old_csrc, Path(tmp) / "earlier"),
                  "current": build(_build.CSRC, Path(tmp) / "current")}
        for side in builds:
            for n in SOURCES:
                for fn, (ops, loops, frnd) in sass_counts(Path(tmp) / side / f"lib{n}.so", args.out / f"{side}-{n}.sass").items():
                    # pack_kernel matches every unpack_kernel instance too
                    if not re.search(r"topk_kernelI(f|13__nv_bfloat16)(Li32)?E|pack_kernel|"
                                     r"quant(ize)?_kernelI(f|13__nv_bfloat16)(Li32)?E", fn):
                        continue
                    line = f"[sass] {side} {fn}: {sum(ops.values())} instructions, {dict(ops.most_common(12))}"
                    if loops:
                        line += f"; loops {[sum(lp.values()) for lp in loops]} instructions, the first {dict(loops[0].most_common(8))}"
                    if "quant" in fn:
                        line += (f"; FRND {ops['FRND']}; instructions a coded value: in a loop (loop / its FRND) "
                                 f"{[sum(lp.values()) / lp['FRND'] for lp in loops if lp['FRND']]}, "
                                 f"unrolled (each code path) {[] if any(lp['FRND'] for lp in loops) else per_value(frnd)}")
                    print(line)

        dev = "cuda"
        gen = torch.Generator(device=dev).manual_seed(0)
        rows, block, k = 19850, 1024, 205
        nb_node = rows // 10
        x = torch.randn((rows, block), generator=gen, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        results = collections.defaultdict(list)

        def topk(lib, xin):
            out = torch.empty_like(xin)
            name = "block_topk_f32" if xin.dtype == torch.float32 else "block_topk_bf16"
            _build.check(getattr(lib, name)(xin.data_ptr(), out.data_ptr(), rows, block, k, stream), name)
            return out

        q = block_topk_ref(x, k)[:nb_node].contiguous()
        kk = int(torch.count_nonzero(q, dim=1).max())
        kpad = padded_k(kk)

        def pack(lib):
            vals = torch.empty((nb_node, kpad), device=dev)
            idx = torch.empty((nb_node, kpad), dtype=torch.int32, device=dev)
            _build.check(lib.pack_sparse_blocks_f32(q.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                                    nb_node, block, kpad, stream), "pack")
            return vals, idx

        bits = 4
        m, d = 10, 2_032_620  # the main path's leaf: 10 nodes x (101,631 x 20)

        def quant(lib, xin, uin):
            out = torch.empty_like(xin)
            scales = torch.empty((rows, 1), dtype=xin.dtype, device=dev)
            name = "quantize_f32" if xin.dtype == torch.float32 else "quantize_bf16"
            _build.check(getattr(lib, name)(xin.data_ptr(), uin.data_ptr(), out.data_ptr(), scales.data_ptr(),
                                            rows, block, bits, stream), name)
            return out

        def quant_leaf(lib, xin, uin):
            leaf = xin.reshape(-1)[: m * d].reshape(m, d)
            out = torch.empty_like(leaf)
            name = "quantize_leaf_f32" if xin.dtype == torch.float32 else "quantize_leaf_bf16"
            _build.check(getattr(lib, name)(leaf.data_ptr(), uin.data_ptr(), out.data_ptr(), rows, block, d, bits,
                                            stream), name)
            return out

        # the unpack tile at the fused exchange's stacked shape: B1's output of
        # every node packed to 256 records a block (the plain pack), back
        qs = block_topk_ref(x, k)
        svals, sidx = pack_sparse_blocks_ref(qs, padded_k(k), block)
        sback = unpack_sparse_blocks_ref(svals, sidx, block)

        def unpack(lib):
            out = torch.empty((rows, block), device=dev)
            _build.check(lib.unpack_sparse_blocks_f32(svals.data_ptr(), sidx.data_ptr(), out.data_ptr(), rows,
                                                      block, svals.shape[1], stream), "unpack")
            return out

        sbase = torch.randn((m, d), generator=gen, device=dev)

        def unpack_leaf(lib):
            out = torch.empty_like(sbase)
            _build.check(lib.unpack_sparse_blocks_leaf_f32(svals.data_ptr(), sidx.data_ptr(), sbase.data_ptr(),
                                                           out.data_ptr(), m, d, block, svals.shape[1], stream),
                         "unpack leaf")
            return out

        xb = x.to(torch.bfloat16)
        u = torch.rand(x.shape, generator=gen, device=dev)
        ub = torch.rand(x.shape, generator=gen, device=dev, dtype=torch.bfloat16)
        rvals, ridx = pack_sparse_blocks_ref(q, kk, block)
        for side, libs in builds.items():
            for xin in (x, xb):
                got = topk(libs["topk_compress"], xin)
                torch.cuda.synchronize()
                chip_smoke.check(torch.equal(chip_smoke.bits(got), chip_smoke.bits(block_topk_ref(xin, k))),
                                 f"{side} block_topk {xin.dtype} differs from its plain version")
            vals, idx = pack(libs["pack_residuals"])
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(chip_smoke.bits(vals), chip_smoke.bits(rvals)) and torch.equal(idx, ridx),
                             f"{side} pack differs from its plain version")
            got = unpack(libs["pack_residuals"])
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(chip_smoke.bits(got), chip_smoke.bits(sback)) and torch.equal(got, qs),
                             f"{side} unpack differs from its plain version")
            for xin, uin in ((x, u), (xb, ub)):
                got = quant(libs["quantize"], xin, uin)
                torch.cuda.synchronize()
                chip_smoke.check(chip_smoke.same(got, quantize_ref(xin, uin, bits)[0]),
                                 f"{side} quantize {xin.dtype} differs from its plain version")
        for xin, uin in ((x, u), (xb, ub)):
            got = quant_leaf(builds["current"]["quantize"], xin, uin)
            torch.cuda.synchronize()
            chip_smoke.check(chip_smoke.same(got, chip_smoke.quant_leaf_want(xin.reshape(-1)[: m * d].reshape(m, d),
                                                                             uin, bits, block)),
                             f"current quantize leaf {xin.dtype} differs from its plain version")
        for side, libs in builds.items():
            if hasattr(libs["pack_residuals"], "unpack_sparse_blocks_leaf_f32"):
                got = unpack_leaf(libs["pack_residuals"])
                torch.cuda.synchronize()
                chip_smoke.check(
                    chip_smoke.same(got, unpack_sparse_blocks_into_ref(svals, sidx, sbase, block, base=sbase)),
                    f"{side} unpack leaf differs from its plain version")
        print(f"[check] both builds bit-exact: block_topk f32 and bf16 ({rows}, {block}) k={k}, "
              f"pack ({nb_node}, {block}) kpad {kpad}, unpack ({rows}, {svals.shape[1]}) -> ({rows}, {block}), "
              f"quantize f32 and bf16 ({rows}, {block}) bits {bits}; the current quantize leaf ({m}, {d}) and "
              f"unpack leaf onto a ({m}, {d}) base too")

        for side in ("earlier", "current", "current", "earlier"):
            libs = builds[side]
            cases = [("block_topk_f32", lambda: topk(libs["topk_compress"], x)),
                     ("block_topk_bf16", lambda: topk(libs["topk_compress"], xb)),
                     ("pack_sparse_blocks", lambda: pack(libs["pack_residuals"])),
                     ("unpack_sparse_blocks", lambda: unpack(libs["pack_residuals"])),
                     ("quantize_f32", lambda: quant(libs["quantize"], x, u)),
                     ("quantize_bf16", lambda: quant(libs["quantize"], xb, ub))]
            if side == "current":
                cases += [("quantize_leaf_f32", lambda: quant_leaf(libs["quantize"], x, u)),
                          ("quantize_leaf_bf16", lambda: quant_leaf(libs["quantize"], xb, ub))]
            if hasattr(libs["pack_residuals"], "unpack_sparse_blocks_leaf_f32"):  # earlier builds may lack it
                cases += [("unpack_sparse_blocks_leaf_f32", lambda: unpack_leaf(libs["pack_residuals"]))]
            for what, fn in cases:
                t = chip_smoke.timed(fn)
                results[what].append(dict(side=side, ms=t["ms"], call_ms=t["call_ms"], timer=t["timer"]))
                print(f"[ab] {side} {what}: {t}")
    print(json.dumps({"card": smi, "ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
