#!/usr/bin/env python3
"""Drive the PyTorch port of C2DFB on one CUDA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure ends the run with a non-zero exit and no result line):

1. environment: versions, card name and power limit, TF32 off;
2. build: nvcc compiles every kernel source of src/repro_torch/kernels/csrc;
   every kernel's registers and spills are printed, and a spill fails;
3. kernels on edge rows (NaN, +-inf, zeros, ties, -0.0, subnormals) at
   blocks 128 to 4,096 and at the main path's shapes, each against its plain
   version on the card (bit-exact; block top-k and the quantizer in f32 and
   bf16, on tiles and on node-stacked leaves read in place), timed (device
   time by torch.profiler, call time by CUDA events) beside its memory
   bound, a copy_ of the same bytes and, where one exists, a PyTorch
   library call computing the same function;
4. main paths: synchronous C2DFB on the 20 Newsgroups-width coefficient-
   tuning task (p = 101,631, c = 20, m = 10 nodes on a ring, label skew 0.8,
   n = 2,000 synthetic documents), K = 10, T = 3 rounds, once with
   kernel_topk (block top-k must launch exactly 4*K*T times and the rounds
   must meter TOPK_ROUND_BYTES) and once with kernel_quant on a
   torch.Generator (the quantizer must launch 4*K*T times and every round
   must meter 417,834,480 bytes); after each, one more round is timed and
   profiled (device busy share, device time by kernel; the compressor's
   kernel runs 4*K times and no leaf is padded); then KernelQuant and
   KernelBlockTopK on a bf16 leaf of the same width, one bf16 launch each,
   bit for bit against their plain versions;
5. wire bytes: round_wire_bytes_measured on each final state.  kernel_topk:
   the pack kernel launches 4*m times, every block-sparse payload equals the
   sparse codec's byte string and the unpack kernel decodes every pack
   back.  kernel_quant: the inner bytes are 409,704,000 and every quant
   payload re-encodes to itself and decodes within 1 ulp;
6. baselines at the same width, 2 rounds each: MDBO, MADSBO, C2DFB-nc with
   kernel_quant (the quantizer launches 4*K a round) and F2SA; then one MDBO
   and one MADSBO round priced by a WAN fabric, whose wire bytes must equal
   the closed form;
7. the fabric path: run(fabric=WAN with lognormal stragglers,
   schedule=link dropout, obs=a JSONL sink) at the same width with
   kernel_topk, T = 3: launch counts, each node's message bytes against a
   count of its nonzeros, every round's wire bytes against the closed form,
   the JSONL's round and node records (oracle calls, compute_flops,
   hbm_bytes), and the host seconds of the codec measurement and of the
   fabric simulation;
8. the eager asynchronous engine at the same width on the reference's async
   gate fabric (geo, lognormal stragglers), kernel_topk, T = 3: policy sync
   bit-identical to run(); bounded 1 and full, each launching block top-k
   (4*K + 4)*T and pack 4*m*T times; bounded 1 with the acked rule,
   inverse-age damping, a dropout schedule and a JSONL sink (3 round and
   30 node records, wire bytes = the sum of each round's streams);
   kernel_quant with analytic payloads (4*K*T + 1 quantizer launches); and
   async MDBO and MADSBO, 2 rounds each;
9. small input: C2DFB with kernel_topk and with kernel_quant on a small
   task through the kernels and through the plain versions on the host,
   which must agree (the quantizer runs share their samples); a run on
   an Erdos-Renyi graph with a dropout schedule, a fabric and obs, whose
   simulated seconds, wire bytes, compute_flops and hbm_bytes must be equal
   on the card and the host; and an async bounded-1 run on that graph,
   whose ages, bytes, seconds and compute counts must be equal.

The last lines are a {"kernels": [...]} record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet; the bound of every kernel here
TOL = dict(rtol=1e-4, atol=1e-6)

# main-path configuration: the paper's coefficient-tuning width (20 Newsgroups)
TASK = dict(m=10, n=2000, p=101631, c=20, h=0.8, seed=0)
CFG = dict(K=10, compressor="kernel_topk", comp_ratio=0.2, comp_block=1024)
CFG_QUANT = dict(K=10, compressor="kernel_quant", comp_bits=4, comp_block=1024)
T = 3
BASELINE_ROUNDS = 2
# the bytes each of the T kernel_topk rounds meters (the earlier top-k
# kernel metered the same): the count of survivors, so the selection, holds
TOPK_ROUND_BYTES = (1_310_294_720, 1_310_294_624, 1_310_294_560)


def quant_round_bytes() -> tuple[int, int]:
    """(inner, total) bytes a kernel_quant round puts on the wire at TASK:
    2 loops x K steps x 2 messages x m nodes, each message a quant header
    (10 B), nb f32 scales and the bit-packed codes; plus the dense x and s_x
    broadcasts."""
    m, p, c = TASK["m"], TASK["p"], TASK["c"]
    d, bits, block = p * c, CFG_QUANT["comp_bits"], CFG_QUANT["comp_block"]
    message = 10 + 4 * -(-d // block) + -(-d * bits // 8)
    inner = 2 * CFG_QUANT["K"] * 2 * m * message
    return inner, inner + 2 * p * 4 * m


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds a call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_window(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler; returns the device
    activity it saw (kernels, memsets, copies), the host wall seconds and
    the host operators' names with their counts."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops = collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CPU)
    return events, wall, ops


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Mean device milliseconds a call: the summed duration of the device
    activity the profiler (CUPTI) saw over ``iters`` calls; None when it saw
    none."""
    for _ in range(warmup):
        fn()
    events, _, _ = device_window(fn, iters)
    us = sum(e.time_range.elapsed_us() for e in events)
    print(f"[timer] {len(events)} device activities over {iters} calls: "
          f"{sorted({e.name[:40] for e in events})[:4]}")
    return us / 1e3 / iters if us > 0 else None


def timed(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time by the profiler (``ms``), falling back to CUDA events
    when the profiler sees no device activity, and the wall time of a call
    from the host by CUDA events (``call_ms``, launch overhead included)."""
    call = time_ms(fn, iters, warmup)
    dev = device_ms(fn, iters, warmup)
    return {"ms": call if dev is None else dev, "call_ms": call,
            "timer": "cuda_events" if dev is None else "profiler"}


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def copy_ms(nbytes: int) -> float:
    """Device time of one Tensor.copy_ that reads nbytes / 2 and writes
    nbytes / 2: what moving a kernel's bound bytes costs on this card at
    this size, launch and ramp included, beside the bound's ideal rate."""
    src = torch.zeros(nbytes // 8, device="cuda")
    dst = torch.empty_like(src)
    return timed(lambda: dst.copy_(src))["ms"]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# edge rows of phase 3: every block the B1 wrapper takes a distinct kernel
# path for (one warp a row up to 1,024, one CTA a row above), and k at both
# ends and at the main path's ratio
EDGE_BLOCKS = (128, 384, 1024, 2048, 4096)


def edge_rows(block: int, gen, dev) -> torch.Tensor:
    """(7, block) f32 rows: normal values; a NaN lane beside a -0.0 lane;
    +inf and -inf lanes; all zeros; ties from {-1, 0, 1}; a third of the
    lanes -0.0; subnormals (N(0, 1) * 1e-39)."""
    x = torch.randn((7, block), generator=gen, device=dev)
    x[1, 7], x[1, 3] = float("nan"), -0.0
    x[2, 5], x[2, 9] = float("inf"), float("-inf")
    x[3] = 0.0
    x[4] = torch.randint(-1, 2, (block,), generator=gen, device=dev).float()
    x[5, ::3] = -0.0
    x[6] *= 1e-39
    return x


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal NaN positions, and equal bits everywhere else."""
    na = torch.isnan(a)
    return torch.equal(na, torch.isnan(b)) and torch.equal(bits(a)[~na], bits(b)[~na])


def kernel_edges(dev, gen) -> int:
    """B1 (f32 and bf16) and B2 on the edge rows at every EDGE_BLOCKS block
    and k in {1, round(0.2 * block), block}, each bit for bit against its
    plain version; B3 decodes every pack as its plain version does, and
    restores the survivors where all fit.  The NaN row comes back from B1
    unchanged.  Returns the number of cases checked."""
    from repro_torch.kernels.pack_residuals import (
        pack_sparse_blocks,
        pack_sparse_blocks_ref,
        unpack_sparse_blocks,
        unpack_sparse_blocks_ref,
    )
    from repro_torch.kernels.ref import block_topk_ref
    from repro_torch.kernels.topk_compress import block_topk_kernel, block_topk_leaf

    cases = 0
    for block in EDGE_BLOCKS:
        x = edge_rows(block, gen, dev)
        # leaves of 3 nodes whose d is no multiple of block, holding the edge
        # rows; node 2's last (partial) block all zeros.  d % 4 == 0 is read
        # in place, d % 4 == 2 through padded tiles
        flat = torch.cat([x.reshape(-1)] * 2)
        leaves = []
        for d in (2 * block + 100, 2 * block + 102):
            leaf = flat[: 3 * d].reshape(3, d).clone()
            leaf[2, 2 * block:] = 0.0
            leaves.append(leaf)
        for k in sorted({1, int(round(0.2 * block)), block}):
            what = f"block {block} k {k}"
            for dt in (torch.float32, torch.bfloat16):
                xin = x.to(dt)
                got = block_topk_kernel(xin, k)
                torch.cuda.synchronize()
                check(same(got, block_topk_ref(xin, k)), f"block_topk {dt} {what} differs from its plain version")
                check(same(got[1], xin[1]), f"block_topk {dt} {what}: the NaN row did not come back unchanged")
                for leaf in leaves:
                    leaf = leaf.to(dt)
                    d = leaf.shape[1]
                    tiles = torch.nn.functional.pad(leaf, (0, 3 * block - d)).reshape(-1, block)
                    want = block_topk_ref(tiles, k).reshape(3, -1)[:, :d]
                    got = block_topk_leaf(leaf, k, block)
                    torch.cuda.synchronize()
                    check(same(got, want), f"block_topk leaf {dt} {what} d {d} differs from its plain version")
                cases += 1
            for xin in (x, block_topk_kernel(x, k)):
                vals, idx = pack_sparse_blocks(xin, k, block)
                rvals, ridx = pack_sparse_blocks_ref(xin, k, block)
                back = unpack_sparse_blocks(vals, idx, block)
                torch.cuda.synchronize()
                check(torch.equal(bits(vals), bits(rvals)) and torch.equal(idx, ridx),
                      f"pack {what} differs from its plain version")
                check(same(back, unpack_sparse_blocks_ref(vals, idx, block)), f"unpack {what} differs from its plain version")
                if k == block:
                    check(same(back, torch.where(xin != 0, xin, 0.0)), f"unpack(pack(x)) != x at {what}")
                cases += 1
    print(f"[kernels] edge rows: {cases} cases at blocks {EDGE_BLOCKS} (B1 on tiles and on leaves in place, "
          f"B2, B3), bit-exact against the plain versions")
    return cases


# the instance of each kernel that the main path's shapes launch
MAIN_INSTANCES = {
    "block_topk": "warp_topk_kernel<float, 32, 32>",
    "pack_sparse_blocks": "pack_kernel",
    "unpack_sparse_blocks": "unpack_kernel",
    "quantize": "warp_quant_kernel<float, 32, 32>",
}
# the instance of the bf16 quantizer (phase 3 and the bf16 phase; the main path is f32)
QUANT_BF16_INSTANCE = "warp_quant_kernel<__nv_bfloat16, 32, 16>"


def ptxas_report(logs: dict) -> dict:
    """{(source, kernel): (registers, spill store bytes, spill load bytes)}
    for every kernel, from the -Xptxas -v lines of the build logs, with the
    names demangled by c++filt where the toolkit's machine has it."""
    report, cur = {}, None
    for src, log in logs.items():
        if shutil.which("c++filt"):
            log = subprocess.run(["c++filt"], input=log, capture_output=True, text=True, check=True).stdout
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(.+)' for", line):
                fn = m.group(1).replace("(anonymous namespace)::", "").removeprefix("void ")
                cur = (src, fn.split("(")[0])
                report[cur] = [None, 0, 0]
            elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                report[cur][1:] = int(m.group(1)), int(m.group(2))
            elif cur and (m := re.search(r"Used (\d+) registers", line)):
                report[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.pack_residuals import (
        pack_sparse_blocks,
        pack_sparse_blocks_ref,
        unpack_sparse_blocks,
        unpack_sparse_blocks_ref,
    )
    from repro_torch.kernels.ref import block_topk_ref
    from repro_torch.kernels.topk_compress import block_topk_kernel, block_topk_leaf

    m, p, c, block = TASK["m"], TASK["p"], TASK["c"], CFG["comp_block"]
    nb_node = -(-p * c // block)  # 1,985 blocks a node
    rows = m * nb_node            # 19,850 rows a top-k launch
    k = max(1, int(round(CFG["comp_ratio"] * block)))
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_edges(dev, gen)
    x = torch.randn((rows, block), generator=gen, device=dev)
    res = {}

    # B1: block top-k, f32 (the main path) and bf16
    topk = {}
    for name, xin in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        got = block_topk_kernel(xin, k)
        want = block_topk_ref(xin, k)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(want)), f"block_topk {name} differs from its plain version")
        def lib(xin=xin):
            keep = torch.topk(xin.abs(), k, dim=1).indices
            return torch.zeros_like(xin).scatter_(1, keep, xin.gather(1, keep))

        kt = timed(lambda: block_topk_kernel(xin, k))
        topk[name] = dict(
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ms=kt["ms"], call_ms=kt["call_ms"], timer=kt["timer"],
            plain_ms=timed(lambda: block_topk_ref(xin, k), iters=3, warmup=1)["ms"],
            bound_ms=bound_ms(2 * xin.numel() * xin.element_size()),
            copy_ms=copy_ms(2 * xin.numel() * xin.element_size()),
            library_ms=timed(lib, iters=5)["ms"],
        )
        print(f"[kernels] block_topk {name} ({rows}, {block}) k={k}: {topk[name]}")
    # the main path's call: the (m, p * c) leaf read in place
    leaf = x.reshape(-1)[: m * p * c].reshape(m, p * c)
    got = block_topk_leaf(leaf, k, block)
    tiles = torch.nn.functional.pad(leaf, (0, nb_node * block - p * c)).reshape(rows, block)
    want = block_topk_ref(tiles, k).reshape(m, -1)[:, : p * c]
    torch.cuda.synchronize()
    check(torch.equal(bits(got), bits(want)), "block_topk on the leaf in place differs from its plain version")
    leaf_t = timed(lambda: block_topk_leaf(leaf, k, block))
    print(f"[kernels] block_topk f32 leaf ({m}, {p * c}) in place: {leaf_t}")
    q_all = block_topk_kernel(x, k)
    res["block_topk"] = dict(
        name="block_topk", route="cuda", ok=True, redesigned="PR 14",
        source="src/repro_torch/kernels/csrc/topk_compress.cu",
        replaces="src/repro/kernels/topk_compress.py:53",
        shape=[rows, block], k=k,
        max_abs_err=topk["f32"]["max_abs_err"], ms=topk["f32"]["ms"],
        call_ms=topk["f32"]["call_ms"], timer=topk["f32"]["timer"],
        plain_ms=topk["f32"]["plain_ms"], bound_ms=topk["f32"]["bound_ms"],
        bound_by="bytes", copy_ms=topk["f32"]["copy_ms"], library_ms=topk["f32"]["library_ms"],
        library="exact top-k: torch.topk + scatter (not bisection)",
        bf16=dict(name="block_topk_bf16", route="cuda", source="src/repro_torch/kernels/csrc/topk_compress.cu",
                  replaces="src/repro/kernels/topk_compress.py:53", bound_by="bytes", **topk["bf16"]),
        leaf=dict(shape=[m, p * c], ms=leaf_t["ms"], call_ms=leaf_t["call_ms"]),
    )

    # B2: pack one node's blocks of B1's output
    q = q_all[:nb_node].contiguous()
    kk = int(torch.count_nonzero(q, dim=1).max())
    vals, idx = pack_sparse_blocks(q, kk, block)
    rvals, ridx = pack_sparse_blocks_ref(q, kk, block)
    torch.cuda.synchronize()
    check(torch.equal(bits(vals), bits(rvals)), "pack vals differ from the plain version")
    check(torch.equal(idx, ridx), "pack idx differ from the plain version")
    kpad = vals.shape[1]
    res["pack_sparse_blocks"] = dict(
        name="pack_sparse_blocks", route="cuda", ok=True, redesigned="PR 14",
        source="src/repro_torch/kernels/csrc/pack_residuals.cu",
        replaces="src/repro/kernels/pack_residuals.py:71",
        shape=[nb_node, block], k=kk, kpad=kpad,
        max_abs_err=float((vals - rvals).abs().max()),
        **timed(lambda: pack_sparse_blocks(q, kk, block)),
        plain_ms=timed(lambda: pack_sparse_blocks_ref(q, kk, block), iters=5)["ms"],
        bound_ms=bound_ms(q.numel() * 4 + vals.numel() * 8),
        bound_by="bytes", copy_ms=copy_ms(q.numel() * 4 + vals.numel() * 8), library_ms=None,
    )
    print(f"[kernels] pack_sparse_blocks: {res['pack_sparse_blocks']}")

    # B3: unpack is pack's inverse
    back = unpack_sparse_blocks(vals, idx, block)
    rback = unpack_sparse_blocks_ref(vals, idx, block)
    torch.cuda.synchronize()
    check(torch.equal(back, q), "unpack(pack(q)) != q")
    check(torch.equal(bits(back), bits(rback)), "unpack differs from its plain version")
    idx64 = idx.to(torch.int64)
    lib_back = torch.zeros((nb_node, block + 1), device=dev).scatter_add_(1, idx64, vals)[:, :block]
    check(torch.equal(lib_back, back), "scatter_add_ yardstick disagrees with unpack")
    res["unpack_sparse_blocks"] = dict(
        name="unpack_sparse_blocks", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/pack_residuals.cu",
        replaces="src/repro/kernels/pack_residuals.py:100",
        shape=[nb_node, kpad], block=block,
        max_abs_err=float((back - rback).abs().max()),
        **timed(lambda: unpack_sparse_blocks(vals, idx, block)),
        plain_ms=timed(lambda: unpack_sparse_blocks_ref(vals, idx, block), iters=5)["ms"],
        bound_ms=bound_ms(vals.numel() * 8 + back.numel() * 4),
        bound_by="bytes", copy_ms=copy_ms(vals.numel() * 8 + back.numel() * 4),
        library_ms=timed(
            lambda: torch.zeros((nb_node, block + 1), device=dev).scatter_add_(1, idx64, vals)
        )["ms"],
        library="torch.zeros().scatter_add_ into a sentinel column",
    )
    print(f"[kernels] unpack_sparse_blocks: {res['unpack_sparse_blocks']}")
    res["quantize"] = kernel_quantize(dev, x, gen)
    return res


def quant_leaf_want(leaf: torch.Tensor, u: torch.Tensor, bits_: int, block: int) -> torch.Tensor:
    """The plain version of quantize_leaf: quantize_ref on the leaf's
    zero-padded tiles, cut back to (m, d)."""
    from repro_torch.kernels.ref import quantize_ref

    m, d = leaf.shape
    nb = -(-d // block)
    tiles = torch.nn.functional.pad(leaf, (0, nb * block - d)).reshape(m * nb, block)
    return quantize_ref(tiles, u, bits_)[0].reshape(m, -1)[:, :d]


def quant_edges(dev, gen) -> int:
    """B4 f32 and bf16 on the edge rows (NaN, +-inf, zeros, ties, -0.0,
    subnormals) at every EDGE_BLOCKS block and bits 2, 4 and 8, bit for bit
    against quantize_ref (values and scales, NaN positions equal): on tiles,
    and on leaves of 3 nodes holding the edge rows whose d is no multiple of
    block (d % 4 == 0 read in place, d % 4 == 2 through padded tiles).
    Returns the number of cases checked."""
    from repro_torch.kernels.quantize import quantize_kernel, quantize_leaf
    from repro_torch.kernels.ref import quantize_ref

    cases = 0
    for block in EDGE_BLOCKS:
        x = edge_rows(block, gen, dev)
        flat = torch.cat([x.reshape(-1)] * 2)
        leaves = []
        for d in (2 * block + 100, 2 * block + 102):
            leaf = flat[: 3 * d].reshape(3, d).clone()
            leaf[2, 2 * block:] = 0.0
            leaves.append(leaf)
        for dt in (torch.float32, torch.bfloat16):
            xin = x.to(dt)
            u = torch.rand(x.shape, generator=gen, device=dev, dtype=dt)
            ul = torch.rand((9, block), generator=gen, device=dev, dtype=dt)
            for b in (2, 4, 8):
                got, scales = quantize_kernel(xin, u, b)
                want, wscales = quantize_ref(xin, u, b)
                torch.cuda.synchronize()
                what = f"quantize {dt} block {block} bits {b}"
                check(got.dtype == scales.dtype == dt, f"{what}: result dtype {got.dtype}, scales {scales.dtype}")
                check(same(got, want), f"{what} differs from its plain version on the edge rows")
                check(same(scales, wscales), f"{what}: scales differ from the plain version's")
                for leaf in leaves:
                    leaf = leaf.to(dt)
                    got = quantize_leaf(leaf, ul, b, block)
                    torch.cuda.synchronize()
                    check(same(got, quant_leaf_want(leaf, ul, b, block)),
                          f"{what} leaf d {leaf.shape[1]} differs from its plain version")
                cases += 1
    print(f"[kernels] quantize edge rows: {cases} cases (f32 and bf16, tiles and leaves) at blocks {EDGE_BLOCKS}, "
          f"bit-exact against quantize_ref")
    return cases


def kernel_quantize(dev, x, gen) -> dict:
    """B4 at the main path's launch shape (bits 4), bits 2 and 8 on a slice,
    a NaN row and an all-zero row, each bit for bit against quantize_ref;
    then the main path's call, the (m, p * c) leaf read in place, bit for
    bit against quantize_ref on its padded tiles.  Then the same in bf16
    (samples drawn in bf16); both on the edge rows.  Timed: the leaf call
    (the main path's, ``ms``) and the tile call (``tile_ms``)."""
    from repro_torch.kernels.quantize import quantize_kernel, quantize_leaf
    from repro_torch.kernels.ref import quantize_ref

    rows, block = x.shape
    m, d = TASK["m"], TASK["p"] * TASK["c"]
    bits_main = CFG_QUANT["comp_bits"]
    u = torch.rand(x.shape, generator=gen, device=dev)
    small = slice(0, 2048)
    edge = x[:4].clone()
    edge[0, 7] = float("nan")
    edge[1] = 0.0
    for what, xin, uin, b in (
        (f"({rows}, {block}) bits {bits_main}", x, u, bits_main),
        ("(2048, 1024) bits 2", x[small], u[small], 2),
        ("(2048, 1024) bits 8", x[small], u[small], 8),
        ("NaN and zero rows bits 4", edge, u[:4].contiguous(), 4),
    ):
        got, scales = quantize_kernel(xin, uin, b)
        want, wscales = quantize_ref(xin, uin, b)
        torch.cuda.synchronize()
        check(same(got, want), f"quantize {what} differs from its plain version")
        check(same(scales, wscales), f"quantize {what}: scales differ")
        print(f"[kernels] quantize {what}: bit-exact against quantize_ref")
    res = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xt = x.to(dt)
        ut = u if dt == torch.float32 else torch.rand(x.shape, generator=gen, device=dev, dtype=dt)
        leaf = xt.reshape(-1)[: m * d].reshape(m, d)
        got, scales = quantize_kernel(xt, ut, bits_main)
        want, wscales = quantize_ref(xt, ut, bits_main)
        got_leaf = quantize_leaf(leaf, ut, bits_main, block)
        want_leaf = quant_leaf_want(leaf, ut, bits_main, block)
        torch.cuda.synchronize()
        check(got.dtype == scales.dtype == got_leaf.dtype == dt, f"quantize {name} returned another dtype")
        check(same(got, want) and same(scales, wscales), f"quantize {name} ({rows}, {block}) differs from its plain version")
        check(same(got_leaf, want_leaf), f"quantize {name} leaf ({m}, {d}) in place differs from its plain version")
        print(f"[kernels] quantize {name} ({rows}, {block}) and the ({m}, {d}) leaf in place: bit-exact")
        size = xt.element_size()
        kt = timed(lambda: quantize_leaf(leaf, ut, bits_main, block))
        tt = timed(lambda: quantize_kernel(xt, ut, bits_main))
        draw = timed(lambda: torch.rand(x.shape, generator=gen, device=dev, dtype=dt))
        leaf_bytes = (2 * m * d + rows * block) * size  # read the leaf and u, write the leaf
        tile_bytes = 3 * rows * block * size + rows * size  # read x and u, write out and the scales
        res[name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:43",
            shape=[m, d], tile_shape=[rows, block], bits=bits_main,
            max_abs_err=float((got_leaf.float() - want_leaf.float()).nan_to_num().abs().max()),
            ms=kt["ms"], call_ms=kt["call_ms"], timer=kt["timer"],
            plain_ms=timed(lambda: quant_leaf_want(leaf, ut, bits_main, block), iters=5)["ms"],
            bound_ms=bound_ms(leaf_bytes), bound_by="bytes", copy_ms=copy_ms(leaf_bytes), library_ms=None,
            library="none: no single PyTorch call computes it",
            tile_ms=tt["ms"], tile_call_ms=tt["call_ms"], tile_bound_ms=bound_ms(tile_bytes),
            # the U[0,1) draw the kernel is fed (torch.rand, outside the kernel)
            rand_ms=draw["ms"], rand_call_ms=draw["call_ms"], rand_bound_ms=bound_ms(rows * block * size),
        )
        print(f"[kernels] quantize {name}: {res[name]}")
    quant_edges(dev, gen)
    return dict(name="quantize", ok=True, **res["f32"], bf16=dict(name="quantize_bf16", **res["bf16"]))


class RecordedDraws:
    """A random source on the card that keeps its last uniform draw, so a
    check can feed the plain version the kernel's samples."""

    def __init__(self, dev, seed: int):
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.last = None

    def uniform(self, shape, device, dtype=torch.float32):
        self.last = torch.rand(shape, generator=self.gen, device=device, dtype=dtype)
        return self.last

    def choice(self, n, k, device):
        return torch.randperm(n, generator=self.gen, device=device)[:k]


def phase_bf16_leaf(dev) -> dict:
    """KernelQuant and KernelBlockTopK (the main paths' compressors) on a
    node-stacked bf16 leaf of the main width, (m, p, c): one bf16 quantizer
    and one bf16 top-k launch, each reading the leaf in place, each bit for
    bit against its plain version on the padded tiles.  Returns the bf16
    launch counts of the phase."""
    from repro_torch.core.compression import KernelBlockTopK, KernelQuant
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import block_topk_ref

    m, p, c = TASK["m"], TASK["p"], TASK["c"]
    block, d = CFG_QUANT["comp_block"], p * c
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((m, p, c), generator=gen, device=dev).to(torch.bfloat16)
    quant, topk = KernelQuant(bits=CFG_QUANT["comp_bits"], block=block), KernelBlockTopK(ratio=CFG["comp_ratio"], block=block)
    draws = RecordedDraws(dev, 3)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    q = quant.compress_nodes(x, draws)
    k = topk.compress_nodes(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"[bf16] KernelQuant and KernelBlockTopK on a bf16 ({m}, {p}, {c}) leaf in {wall!r} s, launches {counts}")
    check(counts["quantize_bf16"] == 1 and counts["block_topk_bf16"] == 1, "the bf16 kernels did not launch once each")
    check(counts["quantize"] == 0 and counts["block_topk"] == 0, "a bf16 leaf launched an f32 kernel")
    check(q.dtype == k.dtype == torch.bfloat16 and q.shape == k.shape == x.shape, "bf16 compressors changed dtype or shape")
    flat = x.reshape(m, d)
    check(same(q.reshape(m, d), quant_leaf_want(flat, draws.last, quant.bits, block)),
          "KernelQuant on the bf16 leaf differs from its plain version")
    nb = -(-d // block)
    tiles = torch.nn.functional.pad(flat, (0, nb * block - d)).reshape(m * nb, block)
    kk = max(1, int(round(topk.ratio * block)))
    check(same(k.reshape(m, d), block_topk_ref(tiles, kk).reshape(m, -1)[:, :d]),
          "KernelBlockTopK on the bf16 leaf differs from its plain version")
    print("[bf16] both bit-exact against their plain versions on the padded tiles")
    return dict(quantize_bf16=counts["quantize_bf16"], block_topk_bf16=counts["block_topk_bf16"])


def build_task(dev):
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task

    t0 = time.perf_counter()
    bundle = coefficient_tuning_task(**TASK, device=dev)
    torch.cuda.synchronize()
    print(f"[main] task built in {time.perf_counter() - t0:.3f} s: "
          f"y {tuple(bundle.y0.shape)}, train a {tuple(bundle.problem.data_g['a'].shape)}")
    return bundle


def phase_main_path(dev, bundle, cfg_kw: dict, kernel: str, generator=None):
    """T rounds of `run` with ``cfg_kw``; ``kernel`` (a launch counter) must
    count exactly 4*K*T launches.  Returns the final state, config, topology
    and every launch counter of the run."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.kernels import _build

    topo, cfg = ring(TASK["m"]), C2DFBConfig(**cfg_kw)
    tag = f"[main {cfg.compressor}]"
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, mets = run(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T=T, generator=generator, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"{tag} {T} rounds in {wall!r} s ({wall / T!r} s a round on average), launches {counts}, "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    check(counts[kernel] == 4 * cfg.K * T, f"{kernel} launched {counts[kernel]} times, want {4 * cfg.K * T}")
    for k, v in mets.items():
        check(v.shape[0] == T, f"metric {k} has shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v.double()).all()), f"metric {k} is not finite: {v}")
    for leaf in (state.x, state.s_x, state.inner_y.d, state.inner_z.d):
        check(bool(torch.isfinite(leaf).all()), "state holds non-finite values")
    check(tuple(state.inner_y.d.shape) == (TASK["m"], TASK["p"], TASK["c"]), "y has the wrong shape")
    for t in range(T):
        print(f"{tag} round {t}: hypergrad_norm {float(mets['hypergrad_norm'][t])!r} "
              f"measured_bytes {int(mets['measured_bytes'][t])} "
              f"x_consensus_err {float(mets['x_consensus_err'][t])!r}")
    want = quant_round_bytes()[1:] * T if cfg.compressor == "kernel_quant" else TOPK_ROUND_BYTES
    got = tuple(int(b) for b in mets["measured_bytes"])
    check(got == want, f"measured_bytes {got}, want {want}")
    profile_round(bundle.problem, topo, cfg, state, generator, tag)
    return state, cfg, topo, counts


def profile_round(problem, topo, cfg, state, generator, tag) -> None:
    """One more round from the final state (outside the counted run): its
    host wall time, then a device profile of a second one — device busy
    share and the device time by kernel name.  The compressor's kernel runs
    4*K times in it, on the leaves in place: no F.pad of a leaf."""
    from repro_torch.core.c2dfb import c2dfb_round

    tag = tag.replace("[main", "[round")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2dfb_round(state, generator, problem, topo, cfg)
    torch.cuda.synchronize()
    print(f"{tag} steady-state round wall {time.perf_counter() - t0!r} s")
    events, wall, ops = device_window(lambda: c2dfb_round(state, generator, problem, topo, cfg), 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of device intervals, in microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    kernel = "quant_kernel" if cfg.compressor == "kernel_quant" else "topk_kernel"
    launches = sum(n for name, (_, n) in by_name.items() if kernel in name)
    gemms = sum(n for name, (_, n) in by_name.items() if "gemm" in name and "32x32" in name)
    print(f"{tag} profiled round: wall {wall!r} s, device busy {busy / 1e6!r} s "
          f"({busy / 1e6 / wall:.3f} of the wall), {len(events)} device activities; {launches} {kernel} "
          f"launches, {ops['aten::constant_pad_nd']} host pads, {ops['aten::bmm']} bmm ({gemms} long-K GEMM "
          f"kernels), {ops['aten::mm']} mm")
    for name, (us, n) in top:
        print(f"{tag}   {us / 1e3:10.3f} ms  {n:5d}x  {name[:90]}")
    check(launches == 4 * cfg.K, f"{tag} {kernel} ran {launches} times in a round, want {4 * cfg.K}")
    check(ops["aten::constant_pad_nd"] == 0, f"{tag} a round padded {ops['aten::constant_pad_nd']} tensors")


def phase_wire(state, cfg, topo):
    from repro_torch.core.c2dfb import round_wire_bytes_measured
    from repro_torch.core.inner_loop import inner_transmit
    from repro_torch.kernels import _build
    from repro_torch.kernels.pack_residuals import unpack_sparse_blocks
    from repro_torch.net.wire import BlockSparseCodec, SparseCodec, codec_for

    m = topo.m
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    wire = round_wire_bytes_measured(state, cfg, topo)
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"[wire] round_wire_bytes_measured {wire} in {wall:.3f} s, launches {counts}")
    check(counts["pack_sparse_blocks"] == 4 * m, f"pack launched {counts['pack_sparse_blocks']} times, want {4 * m}")
    pack_launches = counts["pack_sparse_blocks"]

    comp = cfg.make_compressor()
    codec = codec_for(comp)
    check(isinstance(codec, BlockSparseCodec), "kernel_topk must pair with the block-sparse codec")
    _build.reset_launch_counts()
    inner = 0
    for inner_state in (state.inner_y, state.inner_z):
        for a, b in ((inner_state.d, inner_state.d_hat), (inner_state.s, inner_state.s_hat)):
            q = inner_transmit(comp, None, a, b)
            for i in range(m):
                qi = q[i].reshape(-1)
                vals, idx, d = codec.pack(qi)
                payload = codec.encode_records(vals, idx, d)
                check(payload == SparseCodec().encode(qi), f"block-sparse payload of node {i} differs")
                inner += len(payload)
                dense = unpack_sparse_blocks(vals, idx, codec.block).reshape(-1)[:d]
                check(torch.equal(dense, qi), f"unpack(pack(q)) != q on node {i}")
    counts = _build.launch_counts()
    check(counts["unpack_sparse_blocks"] == 4 * m, f"unpack launched {counts['unpack_sparse_blocks']} times")
    check(inner * cfg.K == wire["inner_bytes"], "payload bytes disagree with round_wire_bytes_measured")
    print(f"[wire] {4 * m} payloads byte-identical to SparseCodec, {4 * m} unpacks exact, launches {counts}")
    return pack_launches, counts["unpack_sparse_blocks"]


def phase_wire_quant(state, cfg, topo, generator):
    """kernel_quant's wire: the measured inner bytes, and every quant payload
    of one round's messages re-encodes to itself and decodes within 1 ulp
    of the grid (atol max|q| * 2^-21, the reference's contract)."""
    from repro_torch.core.c2dfb import round_wire_bytes_measured
    from repro_torch.core.inner_loop import inner_transmit
    from repro_torch.net.wire import QuantCodec, codec_for

    m = topo.m
    t0 = time.perf_counter()
    wire = round_wire_bytes_measured(state, cfg, topo, generator)
    print(f"[wire kernel_quant] round_wire_bytes_measured {wire} in {time.perf_counter() - t0:.3f} s")
    inner_want = quant_round_bytes()[0]
    check(wire["inner_bytes"] == inner_want, f"inner_bytes {wire['inner_bytes']}, want {inner_want}")

    comp = cfg.make_compressor()
    codec = codec_for(comp)
    check(isinstance(codec, QuantCodec) and codec.block == cfg.comp_block, "kernel_quant must pair with QuantCodec")
    inner, exact, worst = 0, 0, 0.0
    t0 = time.perf_counter()
    for inner_state in (state.inner_y, state.inner_z):
        for a, b in ((inner_state.d, inner_state.d_hat), (inner_state.s, inner_state.s_hat)):
            q = inner_transmit(comp, generator, a, b)
            for i in range(m):
                qi = q[i].reshape(-1).cpu().numpy()
                payload = codec.encode(qi)
                back = codec.decode(payload)
                check(codec.encode(back) == payload, f"quant payload of node {i} does not re-encode to itself")
                err = float(np.abs(back - qi).max())
                check(err <= float(np.abs(qi).max()) * 2.0**-21, f"node {i}: decoded values {err} off the grid")
                exact += int(np.array_equal(back, qi))
                worst = max(worst, err)
                inner += len(payload)
    check(inner * cfg.K == wire["inner_bytes"], "payload bytes disagree with round_wire_bytes_measured")
    print(f"[wire kernel_quant] {4 * m} payloads round-trip in {time.perf_counter() - t0:.3f} s; "
          f"{exact} of {4 * m} decode bit-exact, largest decode error {worst!r}")


def phase_baselines(dev, bundle):
    """The paper's baselines at TASK's width, BASELINE_ROUNDS rounds each:
    finite metrics; C2DFB-nc with kernel_quant launches 4*K quantizers a
    round.  Prints each round's wall time and each baseline's bytes a round."""
    from repro_torch.core import baselines as B
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import ring
    from repro_torch.core.types import node_mean, tree_count, tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.net.wire import scan_tree_bytes

    problem, topo, m = bundle.problem, ring(TASK["m"]), TASK["m"]
    nc_cfg = C2DFBConfig(**CFG_QUANT)
    gen = torch.Generator(device=dev).manual_seed(1)
    mdbo_cfg, madsbo_cfg, f2sa_cfg = B.MDBOConfig(), B.MADSBOConfig(), B.F2SAConfig()
    runs = {
        "mdbo": (B.mdbo_init(bundle.x0, bundle.y0), lambda st: B.mdbo_round(st, problem, topo, mdbo_cfg)),
        "madsbo": (B.madsbo_init(problem, bundle.x0, bundle.y0),
                   lambda st: B.madsbo_round(st, problem, topo, madsbo_cfg)),
        "c2dfb_nc": (B.c2dfb_nc_init(problem, nc_cfg, bundle.x0, bundle.y0),
                     lambda st: B.c2dfb_nc_round(st, gen, problem, topo, nc_cfg)),
        "f2sa": (B.f2sa_init(node_mean(bundle.x0), node_mean(bundle.y0)),
                 lambda st: B.f2sa_round(st, problem, f2sa_cfg)),
    }
    launches = 0
    for name, (state, step) in runs.items():
        _build.reset_launch_counts()
        for r in range(BASELINE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mets = step(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for k, v in mets.items():
                check(bool(torch.isfinite(v.double()).all()), f"{name} metric {k} is not finite: {v}")
            print(f"[baselines] {name} round {r}: wall {wall!r} s, hypergrad_norm {float(mets['hypergrad_norm'])!r}")
        for leaf in tree_leaves(state.x) + tree_leaves(state.y if name != "c2dfb_nc" else state.inner_y.d):
            check(bool(torch.isfinite(leaf).all()), f"{name} state holds non-finite values")
        counts = _build.launch_counts()
        if name == "mdbo":
            nbytes = B.mdbo_round_wire_bytes(state, mdbo_cfg, topo)
        elif name == "madsbo":
            nbytes = B.madsbo_round_wire_bytes(state, madsbo_cfg, topo)
        elif name == "c2dfb_nc":
            want = 4 * nc_cfg.K * BASELINE_ROUNDS
            check(counts["quantize"] == want, f"c2dfb_nc launched the quantizer {counts['quantize']} times, want {want}")
            launches = counts["quantize"]
            # quant messages are shape-static: 2 loops x K steps x 2 messages,
            # plus the dense x and s_x broadcasts
            nbytes = 4 * nc_cfg.K * int(scan_tree_bytes(nc_cfg.make_compressor(), state.inner_y.d))
            nbytes += 2 * tree_count(state.x) * 4 * m
        else:
            nbytes = "none (centralized: no gossip)"
        print(f"[baselines] {name}: bytes a round {nbytes}, launches {counts}")
    return launches


# the fabric phase: the main path priced by a WAN fabric with lognormal
# stragglers under a link-dropout schedule, with the telemetry spine on
FABRIC = dict(profile="wan", straggler="lognormal", sigma=0.6, compute_s=0.02, seed=0)
DROPOUT = dict(p_drop=0.2, seed=0)


def phase_fabric(dev, bundle) -> dict:
    """run(fabric=, schedule=, obs=) at TASK's width with kernel_topk, T
    rounds: block top-k launches 4*K a round (obs counts FLOPs on round 0
    itself) and 4 for the phases (each of the four messages compressed once
    on the final state), pack 4*m times for the phases (each node's
    messages encoded once); each node's message bytes equal the sparse
    format's size of its nonzeros, counted apart from the codec; every
    round's wire bytes equal the closed form; the JSONL holds
    T round and T*m node records with the fleet's oracle calls.  Then the
    codec measurement and the fabric simulation are timed on the host,
    each alone (the simulation again on a trace-less fabric, which must
    give the run's seconds and bytes)."""
    import tempfile

    from repro_torch.core.c2dfb import C2DFBConfig, round_phases, run
    from repro_torch.core.inner_loop import inner_transmit
    from repro_torch.core.topology import ring
    from repro_torch.kernels import _build
    from repro_torch.net import LinkDropoutSchedule, NetTrace, edge_list, make_fabric
    from repro_torch.net.wire import SparseCodec
    from repro_torch.obs import JsonlSink, Obs, read_jsonl

    m, p, c, K = TASK["m"], TASK["p"], TASK["c"], CFG["K"]
    topo, cfg = ring(m), C2DFBConfig(**CFG)
    fabric = make_fabric(topo, trace=NetTrace(), **FABRIC)
    schedule = LinkDropoutSchedule(topo, **DROPOUT)
    with tempfile.TemporaryDirectory() as tmp:
        obs = Obs(sink=JsonlSink(f"{tmp}/run.jsonl"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state, mets = run(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T=T, device=dev,
                          schedule=schedule, fabric=fabric, obs=obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        obs.close()
        records = read_jsonl(f"{tmp}/run.jsonl")
        events = obs.save_timeline(f"{tmp}/trace.json", trace=fabric.trace, node_records=records)
    spans = {r["label"]: r["wall_seconds"] for r in records if r["kind"] == "timing"}
    print(f"[fabric] run(fabric=wan lognormal, schedule=dropout 0.2, obs=jsonl) {T} rounds in {wall!r} s "
          f"(spans {spans}), launches {counts}, peak device memory {torch.cuda.max_memory_allocated()} bytes")
    want_topk = 4 * K * T + 4  # the rounds, the phases' four messages
    check(counts["block_topk"] == want_topk,
          f"block_topk launched {counts['block_topk']} times, want {4 * K * T} (rounds) "
          f"+ 4 (one compression a message measured for the phases)")
    check(counts["pack_sparse_blocks"] == 4 * m, f"pack launched {counts['pack_sparse_blocks']} times, want {4 * m}")
    for k in ("sim_seconds", "wire_bytes"):
        check(isinstance(mets[k], np.ndarray) and mets[k].shape == (T,), f"{k} is not a host array of shape ({T},)")
    check(mets["wire_bytes"].dtype == np.int64 and mets["sim_seconds"].dtype == np.float64, "fabric metric dtypes")

    # the codec measurement alone: each node's four inner messages on the final state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    phases, labels = round_phases(state, cfg, topo)
    codec_s = time.perf_counter() - t0
    per_node = [0] * m  # each node's four inner messages: every out-edge of i carries i's bytes
    for ph in (phases[2], phases[3], phases[2 + 2 * K], phases[3 + 2 * K]):  # y d, y s, z d, z s
        for i, nbytes in {i: b for (i, _), b in ph.items()}.items():
            per_node[i] += nbytes
    # apart from the codec: a sparse payload is its header and a (u32 index,
    # f32 value) record per nonzero of the message
    header = len(SparseCodec().encode(torch.zeros(1)))
    counted = [0] * m
    for inner_state in (state.inner_y, state.inner_z):
        for a, b in ((inner_state.d, inner_state.d_hat), (inner_state.s, inner_state.s_hat)):
            q = inner_transmit(cfg.make_compressor(), None, a, b)
            for i, nnz in enumerate(torch.count_nonzero(q.reshape(m, -1), dim=1).tolist()):
                counted[i] += header + 8 * nnz
    print(f"[fabric] each node's four messages: {per_node} bytes by the codec, {counted} counted apart")
    check(per_node == counted, "the codec's message bytes differ from the count of the messages' nonzeros")
    dense = p * 4  # 406,524 B: one node's x (or s_x) in f32
    sim = make_fabric(topo, **FABRIC)
    sim_s = 0.0
    for t in range(T):
        act = schedule.active_edges(t)
        want = 2 * len(act) * dense + K * sum(per_node[i] for i, _ in act)
        got = int(mets["wire_bytes"][t])
        print(f"[fabric] round {t}: sim_seconds {float(mets['sim_seconds'][t])!r} wire_bytes {got} "
              f"({len(act)} of {len(edge_list(topo))} directed edges active; closed form {want}); "
              f"measured_bytes {int(mets['measured_bytes'][t])}")
        check(got == want, f"round {t}: wire_bytes {got}, closed form {want}")
        t0 = time.perf_counter()
        rep = sim.simulate_round([{e: b for e, b in ph.items() if e in set(act)} for ph in phases], t, labels=labels)
        sim_s += time.perf_counter() - t0
        check(rep["wire_bytes"] == got and rep["sim_seconds"] == float(mets["sim_seconds"][t]),
              f"round {t}: a second simulation of the same phases gave another result")
    undropped = 2 * (K * sum(per_node) + 2 * dense * m)
    print(f"[fabric] host seconds: codec measurement (round_phases, {4 * m} packs) {codec_s!r}, fabric simulation "
          f"({T} rounds, {len(phases)} phases each) {sim_s!r}; an undropped round would put {undropped} bytes on "
          f"the wire, {undropped / int(mets['measured_bytes'][-1])!r} x the last round's measured_bytes")

    rounds = [r for r in records if r["kind"] == "round"]
    nodes = [r for r in records if r["kind"] == "node"]
    print(f"[fabric] JSONL: {len(rounds)} round and {len(nodes)} node records, {len(records)} in all; "
          f"oracle calls a round {rounds[0]['oracle_calls']}; compute_flops {rounds[0]['compute_flops']!r} "
          f"(FlopCounterMode), hbm_bytes {rounds[0]['hbm_bytes']!r} (matrix products' operands and outputs); "
          f"memory_peak_bytes {rounds[0]['memory_peak_bytes']}; merged trace {len(events)} events")
    check(len(rounds) == T and len(nodes) == T * m, "wrong record counts")
    fleet = {"ul_grad": 3 * m, "ll_grad": 2 * (K + 1) * m, "hvp": 0, "jvp": 0}  # {30, 220, 0, 0} at TASK, CFG
    check(all(r["oracle_calls"] == fleet for r in rounds), f"oracle calls differ from the closed form {fleet}")
    check(all(r["compute_flops"] and r["compute_flops"] > 0 for r in rounds), "no FLOPs counted")
    check(all(r["hbm_bytes"] and r["hbm_bytes"] > 0 for r in rounds), "no matrix-product bytes counted")
    check(isinstance(rounds[0]["memory_peak_bytes"], int) and rounds[0]["memory_peak_bytes"] > 0, "no peak memory")
    check([r["wire_bytes"] for r in rounds] == [int(b) for b in mets["wire_bytes"]], "records carry other bytes")
    check(set(spans) == {"cost_analysis", "scan"}, f"timing spans {sorted(spans)}")
    check(len(events) > len(fabric.trace.transfers), "the merged trace lacks events")
    return dict(block_topk=counts["block_topk"], pack_sparse_blocks=counts["pack_sparse_blocks"])


def phase_baselines_fabric(dev, bundle) -> None:
    """One MDBO and one MADSBO round with fabric= at TASK's width: every
    dense broadcast crosses both ring links of its sender, so a round puts
    (K*dy + N*dy + dx) * 4 * 2m bytes on the wire (Q for N with MADSBO)."""
    from repro_torch.core import baselines as B
    from repro_torch.core.topology import ring
    from repro_torch.net import make_fabric

    m, p, c = TASK["m"], TASK["p"], TASK["c"]
    topo = ring(m)
    dx, dy = p, p * c
    for name, cfg, init, step, extra in (
        ("mdbo", B.MDBOConfig(), B.mdbo_init(bundle.x0, bundle.y0), B.mdbo_round, "neumann_N"),
        ("madsbo", B.MADSBOConfig(), B.madsbo_init(bundle.problem, bundle.x0, bundle.y0), B.madsbo_round, "Q"),
    ):
        fabric = make_fabric(topo, **FABRIC)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, mets = step(init, bundle.problem, topo, cfg, fabric=fabric, round_idx=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = (cfg.K * dy + getattr(cfg, extra) * dy + dx) * 4 * 2 * m
        print(f"[baselines fabric] {name}: wall {wall!r} s, wire_bytes {mets['wire_bytes']} (closed form {want}), "
              f"sim_seconds {mets['sim_seconds']!r}")
        check(mets["wire_bytes"] == want, f"{name} wire_bytes {mets['wire_bytes']}, want {want}")
        check(bool(torch.isfinite(mets["hypergrad_norm"])), f"{name} hypergradient is not finite")


# the async phase: the reference's async gate fabric (benchmarks/bench_async.py)
# at the paper's width
GEO = dict(profile="geo", straggler="lognormal", compute_s=0.05, sigma=0.8, seed=0)


def _async_run(tag: str, fn, T_: int):
    """Run ``fn()`` with the launch counts set to 0 just before and read
    just after; prints its wall time, per-round wall time and peak device
    memory.  Returns (result, launch counts)."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"[async] {tag}: {T_} rounds in {wall!r} s ({wall / T_!r} s a round), launches {counts}, "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return out, counts


class RoundParts:
    """Times each round's parts inside a counted async C2DFB run, each
    between device synchronizations: the metering (`inner_message_bytes`,
    the y and the z loop's), the scheduler's `drive_round` and the round
    body (`c2dfb_masked_round`).  Used as a context manager around the run;
    ``parts`` then holds a list of seconds a round for each part."""

    def __enter__(self):
        from repro_torch.async_gossip import engine as E

        self.E = E
        self.saved = (E.inner_message_bytes, E.AsyncScheduler.drive_round, E.c2dfb_masked_round)
        self.parts = {"metering": [], "scheduler": [], "body": []}
        E.inner_message_bytes = self._timed("metering", self.saved[0])
        E.AsyncScheduler.drive_round = self._timed("scheduler", self.saved[1])
        E.c2dfb_masked_round = self._timed("body", self.saved[2])
        return self

    def _timed(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.parts[name].append(time.perf_counter() - t0)
            return out

        return timed

    def __exit__(self, *exc):
        E = self.E
        E.inner_message_bytes, E.AsyncScheduler.drive_round, E.c2dfb_masked_round = self.saved
        met = self.parts["metering"]
        self.parts["metering"] = [a + b for a, b in zip(met[::2], met[1::2])]  # y and z loop, a round
        return False

    def report(self, tag: str, wall: float) -> None:
        other = wall - sum(sum(v) for v in self.parts.values())
        spread = {k: max(v) - min(v) for k, v in self.parts.items() if v}
        print(f"[async parts] {tag}, inside the counted run (s a round): {self.parts}; spread (max - min) "
              f"{spread}; host bookkeeping for the run {other!r} s")


def _finite(tag: str, state, mets) -> None:
    from repro_torch.core.types import tree_leaves

    for k, v in mets.items():
        if torch.is_tensor(v):
            check(bool(torch.isfinite(v.double()).all()), f"{tag}: metric {k} is not finite")
    for leaf in tree_leaves(state.x):
        check(bool(torch.isfinite(leaf).all()), f"{tag}: x holds non-finite values")


def async_breakdown(problem, topo, cfg, state, ledger) -> None:
    """Where a bounded-1 async round's wall goes, each part timed alone from
    the run's final state (outside the counted run): the metering (the 4
    compressions and the host encoding of the 4*m payloads), the
    scheduler's drive_round at those sizes, the delayed round body on the
    last round's ages against the synchronous round body; then one profiled
    delayed round (device busy share, device time by kernel)."""
    from repro_torch.async_gossip import AsyncScheduler, c2dfb_masked_round
    from repro_torch.core.c2dfb import c2dfb_round
    from repro_torch.core.inner_loop import inner_message_bytes
    from repro_torch.net import make_fabric

    comp = cfg.make_compressor()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sizes = [np.add(*inner_message_bytes(inner, comp)) for inner in (state.inner_y, state.inner_z)]
    metering = time.perf_counter() - t0
    sched = AsyncScheduler(make_fabric(topo, **GEO), policy="bounded", bound=1)
    t0 = time.perf_counter()
    sched.drive_round(0, cfg.K, sizes[0], sizes[1], TASK["p"] * 4, GEO["compute_s"] / (2 * cfg.K + 2))
    scheduling = time.perf_counter() - t0
    ages = [r.ages for r in ledger.loops[-2:]]
    depth = sched.depth_for(cfg.K)

    def delayed():
        return c2dfb_masked_round(state, None, *ages, problem=problem, topo=topo, cfg=cfg, depth=depth)

    walls = {}
    for name, fn in (("delayed", delayed), ("sync", lambda: c2dfb_round(state, None, problem, topo, cfg))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    print(f"[async breakdown] bounded 1, alone: metering {metering!r} s, scheduler {scheduling!r} s, delayed round "
          f"body {walls['delayed']!r} s, sync round body {walls['sync']!r} s")
    events, wall, _ = device_window(delayed, 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of device intervals, in microseconds
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    print(f"[async breakdown] profiled delayed round body: wall {wall!r} s, device busy {busy / 1e6!r} s, "
          f"{len(events)} device activities")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[async breakdown]   {us / 1e3:10.3f} ms  {n:5d}x  {name[:90]}")


def phase_async(dev, bundle) -> dict:
    """The eager asynchronous engine at TASK's width with kernel_topk, on the
    geo fabric with lognormal stragglers, T rounds each:

    * ``policy="sync"``: every age is 0, and the state (x, s_x, y, z) and
      every metric (measured_bytes = TOPK_ROUND_BYTES) are bit-identical to
      the synchronous ``run`` with the same config;
    * bounded 1 (every staleness_max <= 1; its round timed part by part,
      `async_breakdown`) and full (every age < K): each
      run (and the sync one) launches B1 (4*K + 4)*T times (4*K in a
      round's inner steps, 4 metering compressions a round) and B2 4*m*T
      times (each node's 4 metered messages a round);
    * bounded 1 with the acked version rule, inverse-age damping, a
      link-dropout schedule and a JSONL sink: T round and T*m node
      records, each round's wire_bytes the sum of its bytes_by_stream;
    * kernel_quant, bounded 1, analytic payloads, 2 rounds: B4 launches
      4*K a round and once for the analytic probe;
    * async MDBO and MADSBO, bounded 1, 2 rounds each (Neumann and HIGP
      steps of 1e-3; at the default steps the reference's own async runs
      of this task blow up from p = 500 on; `phase_small_async_baselines` runs
      the default steps card against host).

    The sync, bounded-1 and full runs time each round's metering, scheduler
    and round body inside the counted run (`RoundParts`).

    Returns the async path's launch counts of B1, B2 and B4."""
    import tempfile

    from repro_torch.async_gossip import run_async, run_baseline_async
    from repro_torch.core import baselines as B
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.net import LinkDropoutSchedule, make_fabric
    from repro_torch.obs import JsonlSink, Obs, read_jsonl

    m, K = TASK["m"], CFG["K"]
    problem, x0, y0 = bundle.problem, bundle.x0, bundle.y0
    topo, cfg = ring(m), C2DFBConfig(**CFG)
    want_b1, want_b2 = (4 * K + 4) * T, 4 * m * T
    launches = {}

    (s0, m0), _ = _async_run("sync run (the reference for policy sync)",
                             lambda: run(problem, topo, cfg, x0, y0, T=T, device=dev), T)
    for policy, bound in (("sync", 0), ("bounded", 1), ("full", 0)):
        tag = f"{policy}{bound if policy == 'bounded' else ''}"
        with RoundParts() as parts:
            t0 = time.perf_counter()
            (state, mets), counts = _async_run(tag, lambda: run(
                problem, topo, cfg, x0, y0, T=T, device=dev, fabric=make_fabric(topo, **GEO),
                async_mode=policy, staleness_bound=bound), T)
            wall = time.perf_counter() - t0
        parts.report(tag, wall)
        _finite(tag, state, mets)
        smax = [int(a) for a in mets["staleness_max"]]
        print(f"[async] {tag}: staleness_max {smax}, staleness_hist {mets['staleness_hist'].tolist()}, "
              f"wire_bytes {mets['wire_bytes'].tolist()}, sim_seconds {mets['sim_seconds'].tolist()}, "
              f"measured_bytes {mets['measured_bytes'].tolist()}")
        check(counts["block_topk"] == want_b1, f"{tag}: block_topk launched {counts['block_topk']} times, "
              f"want {want_b1} (4*K a round's steps + 4 metering compressions, T rounds)")
        check(counts["pack_sparse_blocks"] == want_b2,
              f"{tag}: pack launched {counts['pack_sparse_blocks']} times, want {want_b2}")
        launches[tag] = counts
        if policy == "sync":
            check(max(smax) == 0, "policy sync mixed a stale version")
            for a, b in zip(tree_leaves(s0.x) + tree_leaves(s0.s_x) + list(s0.inner_y) + list(s0.inner_z),
                            tree_leaves(state.x) + tree_leaves(state.s_x) + list(state.inner_y)
                            + list(state.inner_z)):
                check(torch.equal(a, b), "policy sync: the state differs from the sync run's bit for bit")
            for k, v in m0.items():
                check(torch.equal(v, mets[k]), f"policy sync: metric {k} differs from the sync run's")
            check(tuple(int(b) for b in mets["measured_bytes"]) == TOPK_ROUND_BYTES, "policy sync: measured_bytes")
            print("[async] sync: state and metrics bit-identical to run() on the card")
        elif policy == "bounded":
            check(max(smax) <= 1, f"bounded 1: staleness_max {smax}")
            async_breakdown(problem, topo, cfg, state, mets["ledger"])
        else:
            check(max(smax) < K and all(len(h) == K for h in mets["staleness_hist"]), f"full: ages {smax}")
        del state, mets

    # the composed run: acked rule, damping, dropout schedule, telemetry
    with tempfile.TemporaryDirectory() as tmp:
        obs = Obs(sink=JsonlSink(f"{tmp}/async.jsonl"))
        (state, mets), counts = _async_run("bounded1 acked inverse-age dropout obs", lambda: run(
            problem, topo, cfg, x0, y0, T=T, device=dev, fabric=make_fabric(topo, **GEO), async_mode="bounded",
            staleness_bound=1, version_rule="acked", mixing_damping="inverse-age",
            schedule=LinkDropoutSchedule(topo, **DROPOUT), obs=obs), T)
        obs.close()
        records = read_jsonl(f"{tmp}/async.jsonl")
    _finite("composed", state, mets)
    rounds = [r for r in records if r["kind"] == "round"]
    nodes = [r for r in records if r["kind"] == "node"]
    print(f"[async] composed: {len(rounds)} round and {len(nodes)} node records; per round wall_seconds "
          f"{[r['wall_seconds'] for r in rounds]}, bytes_by_stream {[r['bytes_by_stream'] for r in rounds]}, "
          f"staleness_max {[r['staleness_max'] for r in rounds]}, compute_flops {rounds[0]['compute_flops']!r}, "
          f"hbm_bytes {rounds[0]['hbm_bytes']!r}, memory_peak_bytes {rounds[0]['memory_peak_bytes']}")
    check(len(rounds) == T and len(nodes) == T * m, "composed: wrong record counts")
    check(all(r["wire_bytes"] == sum(r["bytes_by_stream"].values()) for r in rounds),
          "composed: a round's wire_bytes is not the sum of its bytes_by_stream")
    check(all("ack" in r["bytes_by_stream"] for r in rounds), "composed: the acked rule put no ack on the wire")
    check(all(r["staleness_max"] <= 1 for r in rounds), "composed: bounded 1 exceeded its bound")
    check(counts["block_topk"] == want_b1 and counts["pack_sparse_blocks"] == want_b2,
          f"composed: launches {counts}, want block_topk {want_b1} and pack {want_b2}")
    launches["composed"] = counts
    del state, mets

    # kernel_quant, analytic payloads (the host quant codec would take seconds
    # a round to measure them)
    Tq = 2
    qcfg = C2DFBConfig(**CFG_QUANT)
    gen = torch.Generator(device=dev).manual_seed(0)
    (state, mets), counts = _async_run("kernel_quant bounded1 analytic", lambda: run_async(
        problem, topo, qcfg, x0, y0, Tq, gen, make_fabric(topo, **GEO), policy="bounded", bound=1,
        payload_bytes="analytic", device=dev), Tq)
    _finite("kernel_quant", state, mets)
    want_q = 4 * K * Tq + 1  # the rounds' steps, and the analytic probe once
    check(counts["quantize"] == want_q, f"kernel_quant: quantize launched {counts['quantize']} times, want {want_q}")
    check(counts["block_topk"] == 0 and counts["quantize_bf16"] == 0, f"kernel_quant: launches {counts}")
    print(f"[async] kernel_quant: wire_bytes {mets['wire_bytes'].tolist()}, staleness_max "
          f"{mets['staleness_max'].tolist()}")
    launches["kernel_quant"] = counts
    del state, mets

    # at the default Neumann and HIGP steps (0.1) the reference's own async
    # MDBO and MADSBO runs of this task (m = 10, n = 2,000, c = 20, ring, geo
    # fabric, bounded 1) grow without bound from p = 500 on and reach NaN
    # within 2 rounds from p = 1,000 on, the port's with them (ROADMAP §C):
    # steps of 1e-3 keep both finite at the paper's width
    for alg, bcfg in (("mdbo", B.MDBOConfig(neumann_eta=1e-3)), ("madsbo", B.MADSBOConfig(eta_v=1e-3))):
        (state, mets), counts = _async_run(f"{alg} bounded1", lambda: run_baseline_async(
            alg, problem, topo, bcfg, x0, y0, BASELINE_ROUNDS, make_fabric(topo, **GEO), policy="bounded",
            bound=1, device=dev), BASELINE_ROUNDS)
        _finite(alg, state, mets)
        print(f"[async] {alg}: hypergrad_norm {mets['hypergrad_norm'].tolist()}, wire_bytes "
              f"{mets['wire_bytes'].tolist()}, sim_seconds {mets['sim_seconds'].tolist()}, max age "
              f"{mets['ledger'].max_age()}")
        check(mets["ledger"].max_age() <= 1, f"{alg}: bounded 1 exceeded its bound")
        del state, mets
    return dict(
        block_topk=launches["bounded1"]["block_topk"], pack_sparse_blocks=launches["bounded1"]["pack_sparse_blocks"],
        quantize=launches["kernel_quant"]["quantize"],
    )


# the Erdős–Rényi graph make_topology("er", 10, p=0.4, seed=0) draws
ER_EDGES = [(0, 1), (0, 5), (0, 6), (1, 2), (1, 4), (1, 6), (1, 7), (2, 6), (2, 7),
            (2, 8), (2, 9), (3, 7), (4, 8), (5, 9), (6, 8), (6, 9), (7, 9), (8, 9)]


class HostDraws:
    """A random source that draws on the host from a seeded CPU generator
    and copies to the run's device, so a card run and a host run share
    their samples."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def uniform(self, shape, device, dtype=torch.float32):
        return torch.rand(shape, generator=self.gen, dtype=dtype).to(device)

    def choice(self, n, k, device):
        return torch.randperm(n, generator=self.gen)[:k].to(device)


# the samples of the small kernel_quant run: of seeds 0-99 the one whose
# smallest distance between a sample and its rounding threshold is largest
# on the host, 5.9e-5 (quantization is discontinuous; card and host sum in
# another order, so a sample near its threshold could round differently)
SMALL_QUANT_SEED = 29


def phase_small_input(dev):
    """The algorithm through the kernels (card) and through the plain
    versions (host) on one small input, with kernel_topk and with
    kernel_quant (shared samples): the two must agree."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task

    task = dict(m=4, n=200, p=64, c=4, seed=0)
    for cfg in (C2DFBConfig(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128),
                C2DFBConfig(K=3, compressor="kernel_quant", comp_bits=4, comp_block=128)):
        out = {}
        for d in ("cpu", dev):
            b = coefficient_tuning_task(**task, device=d)
            out[d] = run(b.problem, ring(4), cfg, b.x0, b.y0, T=3, generator=HostDraws(SMALL_QUANT_SEED), device=d)
        (sc, mc), (sg, mg) = out["cpu"], out[dev]
        for what, a, b in (("x", sc.x, sg.x), ("s_x", sc.s_x, sg.s_x), ("y", sc.inner_y.d, sg.inner_y.d),
                           ("z", sc.inner_z.d, sg.inner_z.d)):
            for la, lb in zip(tree_leaves(a), tree_leaves(b)):
                check(torch.allclose(lb.cpu(), la, **TOL), f"small input {cfg.compressor}: {what} differs between card and host")
        check(torch.equal(mc["measured_bytes"], mg["measured_bytes"].cpu()),
              f"small input {cfg.compressor}: measured_bytes differ")
        print(f"[small] {cfg.compressor}: card and host agree (rtol {TOL['rtol']}, atol {TOL['atol']}); "
              f"measured_bytes {mc['measured_bytes'].tolist()}")
    phase_small_fabric(dev)


def phase_small_fabric(dev):
    """A small run on the Erdős–Rényi graph (its 18 edges checked) with a
    dropout schedule, a WAN fabric and obs, on the card and on the host: the
    states agree within TOL; sim_seconds, wire_bytes and the round records'
    compute_flops and hbm_bytes exactly."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import make_topology
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.net import LinkDropoutSchedule, make_fabric
    from repro_torch.net.dynamic import base_edges
    from repro_torch.obs import MemorySink, Obs

    topo = make_topology("er", 10, p=0.4, seed=0)
    check(base_edges(topo) == ER_EDGES, f"er(10, 0.4, seed 0) drew {base_edges(topo)}")
    cfg = C2DFBConfig(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    out, costs = {}, {}
    for d in ("cpu", dev):
        b = coefficient_tuning_task(m=10, n=400, p=64, c=4, seed=0, device=d)
        sink = MemorySink()
        out[d] = run(b.problem, topo, cfg, b.x0, b.y0, T=3, device=d, obs=Obs(sink=sink),
                     schedule=LinkDropoutSchedule(topo, **DROPOUT), fabric=make_fabric(topo, **FABRIC))
        costs[d] = [(r["compute_flops"], r["hbm_bytes"]) for r in sink.rows(kind="round")]
    (sc, mc), (sg, mg) = out["cpu"], out[dev]
    for la, lb in zip(tree_leaves(sc.x) + tree_leaves(sc.inner_y.d), tree_leaves(sg.x) + tree_leaves(sg.inner_y.d)):
        check(torch.allclose(lb.cpu(), la, **TOL), "small fabric run: the card's state differs from the host's")
    for k in ("sim_seconds", "wire_bytes"):
        check(np.array_equal(mc[k], mg[k]), f"small fabric run: {k} differs between card and host")
    check(costs["cpu"] == costs[dev], f"small fabric run: (compute_flops, hbm_bytes) {costs[dev][0]} on the card, "
          f"{costs['cpu'][0]} on the host")
    print(f"[small] er(10, 0.4) with dropout and a WAN fabric: card and host agree; wire_bytes "
          f"{mg['wire_bytes'].tolist()}, sim_seconds {mg['sim_seconds'].tolist()}, (compute_flops, hbm_bytes) "
          f"{costs[dev][0]}")
    phase_small_async(dev, topo, cfg)


def phase_small_async(dev, topo, cfg):
    """An async bounded-1 run on the Erdős–Rényi graph with the geo fabric
    and obs, on the card and on the host: ages, staleness, wire bytes,
    simulated seconds, measured bytes and the round records' compute_flops
    and hbm_bytes equal; the states within TOL."""
    from repro_torch.async_gossip import run_async
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.net import make_fabric
    from repro_torch.obs import MemorySink, Obs

    out, costs, ledgers = {}, {}, {}
    for d in ("cpu", dev):
        b = coefficient_tuning_task(m=10, n=400, p=64, c=4, seed=0, device=d)
        sink = MemorySink()
        out[d] = run_async(b.problem, topo, cfg, b.x0, b.y0, 3, fabric=make_fabric(topo, **GEO), policy="bounded",
                           bound=1, obs=Obs(sink=sink), device=d)
        costs[d] = [(r["compute_flops"], r["hbm_bytes"]) for r in sink.rows(kind="round")]
        ledgers[d] = out[d][1]["ledger"]
    (sc, mc), (sg, mg) = out["cpu"], out[dev]
    for la, lb in zip(tree_leaves(sc.x) + tree_leaves(sc.inner_y.d), tree_leaves(sg.x) + tree_leaves(sg.inner_y.d)):
        check(torch.allclose(lb.cpu(), la, **TOL), "small async run: the card's state differs from the host's")
    for k in ("sim_seconds", "wire_bytes", "staleness_max", "staleness_mean", "staleness_hist"):
        check(np.array_equal(mc[k], mg[k]), f"small async run: {k} differs between card and host")
    check(torch.equal(mc["measured_bytes"], mg["measured_bytes"].cpu()), "small async run: measured_bytes differ")
    check(all(np.array_equal(a.ages, b.ages) for a, b in zip(ledgers["cpu"].loops, ledgers[dev].loops)),
          "small async run: ages differ between card and host")
    check(costs["cpu"] == costs[dev], f"small async run: (compute_flops, hbm_bytes) {costs[dev][0]} on the card, "
          f"{costs['cpu'][0]} on the host")
    print(f"[small] async bounded 1 on er(10, 0.4) with the geo fabric: card and host agree; wire_bytes "
          f"{mg['wire_bytes'].tolist()}, staleness_max {mg['staleness_max'].tolist()}, (compute_flops, hbm_bytes) "
          f"{costs[dev][0]}")
    phase_small_async_baselines(dev, topo)


def phase_small_async_baselines(dev, topo):
    """Async MDBO and MADSBO, bounded 1, at their default steps on the
    Erdős–Rényi graph with the geo fabric and obs, 2 rounds on the card and
    on the host: ages, wire bytes, simulated seconds and the round records'
    compute_flops and hbm_bytes equal; the states and the hypergradient
    norms within TOL."""
    from repro_torch.async_gossip import run_baseline_async
    from repro_torch.core import baselines as B
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.net import make_fabric
    from repro_torch.obs import MemorySink, Obs

    for alg, bcfg in (("mdbo", B.MDBOConfig()), ("madsbo", B.MADSBOConfig())):
        out, costs = {}, {}
        for d in ("cpu", dev):
            b = coefficient_tuning_task(m=10, n=400, p=64, c=4, seed=0, device=d)
            sink = MemorySink()
            out[d] = run_baseline_async(alg, b.problem, topo, bcfg, b.x0, b.y0, BASELINE_ROUNDS,
                                        make_fabric(topo, **GEO), policy="bounded", bound=1, obs=Obs(sink=sink),
                                        device=d)
            costs[d] = [(r["compute_flops"], r["hbm_bytes"]) for r in sink.rows(kind="round")]
        (sc, mc), (sg, mg) = out["cpu"], out[dev]
        _finite(f"small async {alg}", sg, mg)
        for la, lb in zip(tree_leaves(sc.x) + tree_leaves(sc.y), tree_leaves(sg.x) + tree_leaves(sg.y)):
            check(torch.allclose(lb.cpu(), la, **TOL), f"small async {alg}: the card's state differs from the host's")
        check(torch.allclose(mg["hypergrad_norm"].cpu(), mc["hypergrad_norm"], **TOL),
              f"small async {alg}: hypergrad_norm differs between card and host")
        for k in ("sim_seconds", "wire_bytes"):
            check(np.array_equal(mc[k], mg[k]), f"small async {alg}: {k} differs between card and host")
        check(all(np.array_equal(a.ages, b.ages) for a, b in zip(mc["ledger"].loops, mg["ledger"].loops)),
              f"small async {alg}: ages differ between card and host")
        check(mg["ledger"].max_age() == 1, f"small async {alg}: max age {mg['ledger'].max_age()}, want 1")
        check(costs["cpu"] == costs[dev], f"small async {alg}: (compute_flops, hbm_bytes) {costs[dev][0]} on the "
              f"card, {costs['cpu'][0]} on the host")
        print(f"[small] async {alg} bounded 1 at its default steps on er(10, 0.4): card and host agree; "
              f"hypergrad_norm {mg['hypergrad_norm'].tolist()}, wire_bytes {mg['wire_bytes'].tolist()}, "
              f"(compute_flops, hbm_bytes) {costs[dev][0]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # 1. environment
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[env] {smi}; devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.3f} s")
    ptxas = ptxas_report(_build.BUILD_LOGS)
    for (src, fn), (regs, st, ld) in sorted(ptxas.items()):
        print(f"[build] {src}: {fn}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    check(ptxas and not any(st or ld for _, st, ld in ptxas.values()), "a kernel spills registers (or ptxas said nothing)")

    # 3. kernels at main-path shapes
    kernels = phase_kernels(dev)
    for entry, fn in [(kernels[n], f) for n, f in MAIN_INSTANCES.items()] + [
        (kernels["quantize"]["bf16"], QUANT_BF16_INSTANCE)
    ]:
        found = [v for (_, f), v in ptxas.items() if f == fn]
        check(len(found) == 1, f"ptxas reported no kernel {fn}")
        entry["registers"], st, ld = found[0]
        entry["spill_bytes"] = st + ld
    # 4. main paths: kernel_topk, then kernel_quant on the same task (f32 leaves)
    bundle = build_task(dev)
    state, cfg, topo, counts = phase_main_path(dev, bundle, CFG, "block_topk")
    kernels["block_topk"]["launches"] = counts["block_topk"]
    gen = torch.Generator(device=dev).manual_seed(0)
    qstate, qcfg, _, counts = phase_main_path(dev, bundle, CFG_QUANT, "quantize", gen)
    kernels["quantize"]["launches"] = counts["quantize"]
    check(counts["block_topk_bf16"] == counts["quantize_bf16"] == 0, "an f32 main path launched a bf16 kernel")
    # the bf16 instances: both compressors on a bf16 leaf of the main width
    bf16 = phase_bf16_leaf(dev)
    kernels["block_topk"]["bf16"]["launches"] = bf16["block_topk_bf16"]
    kernels["quantize"]["bf16"]["launches"] = bf16["quantize_bf16"]
    # 5. wire bytes through pack / unpack, and through the quant codec
    pack_launches, unpack_launches = phase_wire(state, cfg, topo)
    kernels["pack_sparse_blocks"]["launches"] = pack_launches
    kernels["unpack_sparse_blocks"]["launches"] = unpack_launches
    phase_wire_quant(qstate, qcfg, topo, gen)
    del state, qstate
    # 6. the paper's baselines at full width, then MDBO and MADSBO priced by a fabric
    kernels["quantize"]["c2dfb_nc_launches"] = phase_baselines(dev, bundle)
    phase_baselines_fabric(dev, bundle)
    # 7. the main path priced by a fabric, under a schedule, with telemetry
    fab = phase_fabric(dev, bundle)
    kernels["block_topk"]["fabric_launches"] = fab["block_topk"]
    kernels["pack_sparse_blocks"]["fabric_launches"] = fab["pack_sparse_blocks"]
    # 8. the eager asynchronous engine (C2DFB, MDBO, MADSBO) at the same width
    asy = phase_async(dev, bundle)
    kernels["block_topk"]["async_launches"] = asy["block_topk"]
    kernels["pack_sparse_blocks"]["async_launches"] = asy["pack_sparse_blocks"]
    kernels["quantize"]["async_launches"] = asy["quantize"]
    del bundle
    # 9. small input, card against host (with a fabric and a schedule, and async too)
    phase_small_input(dev)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
