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
   version on the card (bit-exact; the quantizer in f32 and bf16), timed
   (device time by torch.profiler, call time by CUDA events) beside its
   memory bound, a copy_ of the same bytes and, where one exists, a PyTorch
   library call computing the same function;
4. main paths: synchronous C2DFB on the 20 Newsgroups-width coefficient-
   tuning task (p = 101,631, c = 20, m = 10 nodes on a ring, label skew 0.8,
   n = 2,000 synthetic documents), K = 10, T = 3 rounds, once with
   kernel_topk (block top-k must launch exactly 4*K*T times and the rounds
   must meter TOPK_ROUND_BYTES) and once with kernel_quant on a
   torch.Generator (the quantizer must launch 4*K*T times and every round
   must meter 417,834,480 bytes); after each, one more
   round is timed and profiled (device busy share, device time by kernel);
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
   count of its nonzeros, every round's wire bytes against the closed form, the JSONL's round and node records and oracle calls, and
   the host seconds of the codec measurement and of the fabric simulation;
8. small input: C2DFB with kernel_topk and with kernel_quant on a small
   task through the kernels and through the plain versions on the host,
   which must agree (the quantizer runs share their samples); and a run on
   an Erdos-Renyi graph with a dropout schedule and a fabric, whose
   simulated seconds and wire bytes must be equal on the card and the host.

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
    activity it saw (kernels, memsets, copies) and the host wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return events, wall


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Mean device milliseconds a call: the summed duration of the device
    activity the profiler (CUPTI) saw over ``iters`` calls; None when it saw
    none."""
    for _ in range(warmup):
        fn()
    events, _ = device_window(fn, iters)
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
    "quantize": "quantize_kernel<float>",
}
# the instance of the bf16 quantizer (phase 3; the main path is f32)
QUANT_BF16_INSTANCE = "quantize_kernel<__nv_bfloat16>"


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


def quant_edges(dev, gen) -> int:
    """B4 f32 and bf16 on the edge rows (NaN, +-inf, zeros, ties, -0.0,
    subnormals) at every EDGE_BLOCKS block and bits 2, 4 and 8, bit for bit
    against quantize_ref (values and scales, NaN positions equal).  Returns
    the number of cases checked."""
    from repro_torch.kernels.quantize import quantize_kernel
    from repro_torch.kernels.ref import quantize_ref

    cases = 0
    for block in EDGE_BLOCKS:
        x = edge_rows(block, gen, dev)
        for dt in (torch.float32, torch.bfloat16):
            xin = x.to(dt)
            u = torch.rand(x.shape, generator=gen, device=dev, dtype=dt)
            for b in (2, 4, 8):
                got, scales = quantize_kernel(xin, u, b)
                want, wscales = quantize_ref(xin, u, b)
                torch.cuda.synchronize()
                what = f"quantize {dt} block {block} bits {b}"
                check(got.dtype == scales.dtype == dt, f"{what}: result dtype {got.dtype}, scales {scales.dtype}")
                check(same(got, want), f"{what} differs from its plain version on the edge rows")
                check(same(scales, wscales), f"{what}: scales differ from the plain version's")
                cases += 1
    print(f"[kernels] quantize edge rows: {cases} cases (f32 and bf16) at blocks {EDGE_BLOCKS}, "
          f"bit-exact against quantize_ref")
    return cases


def kernel_quantize(dev, x, gen) -> dict:
    """B4 at the main path's launch shape (bits 4), bits 2 and 8 on a slice,
    a NaN row and an all-zero row; each bit for bit against quantize_ref.
    Then B4 bf16 at the same shape (samples drawn in bf16), bit for bit and
    timed; and both on the edge rows."""
    from repro_torch.kernels.quantize import quantize_kernel
    from repro_torch.kernels.ref import quantize_ref

    rows, block = x.shape
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
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan), f"quantize {what}: NaN positions differ")
        check(torch.equal(bits(got[~nan]), bits(want[~nan])), f"quantize {what} differs from its plain version")
        check(torch.equal(bits(scales.nan_to_num()), bits(wscales.nan_to_num())), f"quantize {what}: scales differ")
        print(f"[kernels] quantize {what}: bit-exact against quantize_ref")
    got, _ = quantize_kernel(x, u, bits_main)
    want, _ = quantize_ref(x, u, bits_main)
    kt = timed(lambda: quantize_kernel(x, u, bits_main))
    draw = timed(lambda: torch.rand(x.shape, generator=gen, device=dev))
    res = dict(
        name="quantize", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:43",
        shape=[rows, block], bits=bits_main,
        max_abs_err=float((got - want).abs().max()),
        ms=kt["ms"], call_ms=kt["call_ms"], timer=kt["timer"],
        plain_ms=timed(lambda: quantize_ref(x, u, bits_main), iters=5)["ms"],
        # read x and u, write out and the (rows,) scales
        bound_ms=bound_ms(3 * x.numel() * 4 + rows * 4),
        bound_by="bytes", copy_ms=copy_ms(3 * x.numel() * 4 + rows * 4), library_ms=None,
        library="none: no single PyTorch call computes it",
        # the U[0,1) draw the kernel is fed (torch.rand, outside the kernel)
        rand_ms=draw["ms"], rand_call_ms=draw["call_ms"], rand_bound_ms=bound_ms(x.numel() * 4),
    )
    print(f"[kernels] quantize: {res}")

    # bf16: x rounded to bf16, u drawn in bf16 (as KernelQuant draws for a bf16 leaf)
    xb = x.to(torch.bfloat16)
    ub = torch.rand(x.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    got, scales = quantize_kernel(xb, ub, bits_main)
    want, wscales = quantize_ref(xb, ub, bits_main)
    torch.cuda.synchronize()
    check(got.dtype == scales.dtype == torch.bfloat16, "quantize bf16 returned another dtype")
    check(torch.equal(bits(got), bits(want)), f"quantize bf16 ({rows}, {block}) differs from its plain version")
    check(torch.equal(bits(scales), bits(wscales)), "quantize bf16 scales differ from the plain version's")
    kt = timed(lambda: quantize_kernel(xb, ub, bits_main))
    nbytes = 3 * xb.numel() * 2 + rows * 2  # read x and u, write out and the (rows,) scales
    res["bf16"] = dict(
        name="quantize_bf16", route="cuda", source=res["source"], replaces=res["replaces"],
        shape=[rows, block], bits=bits_main,  # launches: the kernel_quant main path's count, set in main()
        max_abs_err=float((got.float() - want.float()).abs().max()),
        ms=kt["ms"], call_ms=kt["call_ms"], timer=kt["timer"],
        plain_ms=timed(lambda: quantize_ref(xb, ub, bits_main), iters=5)["ms"],
        bound_ms=bound_ms(nbytes), bound_by="bytes", copy_ms=copy_ms(nbytes), library_ms=None,
        rand_ms=timed(lambda: torch.rand(x.shape, generator=gen, device=dev, dtype=torch.bfloat16))["ms"],
        rand_bound_ms=bound_ms(x.numel() * 2),
    )
    print(f"[kernels] quantize bf16: {res['bf16']}")
    quant_edges(dev, gen)
    return res


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
    share and the device time by kernel name."""
    from repro_torch.core.c2dfb import c2dfb_round

    tag = tag.replace("[main", "[round")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2dfb_round(state, generator, problem, topo, cfg)
    torch.cuda.synchronize()
    print(f"{tag} steady-state round wall {time.perf_counter() - t0!r} s")
    events, wall = device_window(lambda: c2dfb_round(state, generator, problem, topo, cfg), 1)
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
    print(f"{tag} profiled round: wall {wall!r} s, device busy {busy / 1e6!r} s "
          f"({busy / 1e6 / wall:.3f} of the wall), {len(events)} device activities")
    for name, (us, n) in top:
        print(f"{tag}   {us / 1e3:10.3f} ms  {n:5d}x  {name[:90]}")


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
          f"(FlopCounterMode); memory_peak_bytes {rounds[0]['memory_peak_bytes']}; merged trace {len(events)} events")
    check(len(rounds) == T and len(nodes) == T * m, "wrong record counts")
    fleet = {"ul_grad": 3 * m, "ll_grad": 2 * (K + 1) * m, "hvp": 0, "jvp": 0}  # {30, 220, 0, 0} at TASK, CFG
    check(all(r["oracle_calls"] == fleet for r in rounds), f"oracle calls differ from the closed form {fleet}")
    check(all(r["compute_flops"] and r["compute_flops"] > 0 for r in rounds), "no FLOPs counted")
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
    dropout schedule and a WAN fabric, on the card and on the host: the
    states agree within TOL, sim_seconds and wire_bytes exactly."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import make_topology
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.net import LinkDropoutSchedule, make_fabric
    from repro_torch.net.dynamic import base_edges

    topo = make_topology("er", 10, p=0.4, seed=0)
    check(base_edges(topo) == ER_EDGES, f"er(10, 0.4, seed 0) drew {base_edges(topo)}")
    cfg = C2DFBConfig(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    out = {}
    for d in ("cpu", dev):
        b = coefficient_tuning_task(m=10, n=400, p=64, c=4, seed=0, device=d)
        out[d] = run(b.problem, topo, cfg, b.x0, b.y0, T=3, device=d,
                     schedule=LinkDropoutSchedule(topo, **DROPOUT), fabric=make_fabric(topo, **FABRIC))
    (sc, mc), (sg, mg) = out["cpu"], out[dev]
    for la, lb in zip(tree_leaves(sc.x) + tree_leaves(sc.inner_y.d), tree_leaves(sg.x) + tree_leaves(sg.inner_y.d)):
        check(torch.allclose(lb.cpu(), la, **TOL), "small fabric run: the card's state differs from the host's")
    for k in ("sim_seconds", "wire_bytes"):
        check(np.array_equal(mc[k], mg[k]), f"small fabric run: {k} differs between card and host")
    print(f"[small] er(10, 0.4) with dropout and a WAN fabric: card and host agree; wire_bytes "
          f"{mg['wire_bytes'].tolist()}, sim_seconds {mg['sim_seconds'].tolist()}")


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
    # 4. main paths: kernel_topk, then kernel_quant on the same task
    bundle = build_task(dev)
    # (the main paths run f32 leaves: the bf16 instances' counts are read all the same)
    state, cfg, topo, counts = phase_main_path(dev, bundle, CFG, "block_topk")
    kernels["block_topk"]["launches"] = counts["block_topk"]
    kernels["block_topk"]["bf16"]["launches"] = counts["block_topk_bf16"]
    gen = torch.Generator(device=dev).manual_seed(0)
    qstate, qcfg, _, counts = phase_main_path(dev, bundle, CFG_QUANT, "quantize", gen)
    kernels["quantize"]["launches"] = counts["quantize"]
    kernels["quantize"]["bf16"]["launches"] = counts["quantize_bf16"]
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
    del bundle
    # 8. small input, card against host (with a fabric and a schedule too)
    phase_small_input(dev)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
