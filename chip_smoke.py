#!/usr/bin/env python3
"""Drive the PyTorch port of C2DFB on one CUDA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root; needs one card
    python3 chip_smoke.py --only transport   # the build, phase 4's top-k run, then phase 11
    python3 chip_smoke.py --only archs   # the build, then phase 13 alone
    python3 chip_smoke.py --only steps   # the build, then phase 14 alone
    python3 chip_smoke.py --only examples   # the build, then phase 16 alone

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
   library call computing the same function; the unpack kernel's tile and
   leaf entries on edge records (duplicates, sentinels, negative and
   out-of-range indices, -0.0 and NaN values, -0.0 bases) at blocks 128 to
   4,096 and 12,288, f32 and bf16 leaves, d % block != 0 and d % 4 != 0,
   with and without a base;
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
   whose ages, bytes, seconds and compute counts must be equal;
10. the compiled runtime (a scheduler replay, then each branch's round body
   captured once in a CUDA graph and replayed): at the width of phase 8,
   every policy, the composed run, kernel_quant and async MDBO and MADSBO
   bit for bit against the eager engine with analytic payloads, at most
   one capture a branch, B1 and B4 launched 4*K*T times by the profiler's
   count, peak memory and seconds a round (eager measured, eager analytic,
   compiled cold and warm); at the compiled-axis config of the reference's
   async benchmark, T = 50: eager against compiled cold and warm, captures
   equal at T = 25 and 50, the replay loop under
   set_sync_debug_mode("error") and its device idle share; and a compiled
   run on er(10, 0.4), card against host;
11. the transports, at the width of phase 4 on the ring with a WAN pricing
   fabric, T = 1: run(transport=DeviceTransport(fused=True)), every
   residual packed on the card (B2) and unpacked by every receiver (B3):
   B1 40, B2 40, B3 120 launches, no block over kpad survivors, each
   round's wire bytes the degree sum of its node bytes, one fused round
   body profiled; the dense exchange metered in the same chunked format,
   bit for bit the fused run (state, every metric, every node's bytes on
   every step and round: measure_tree_bytes_chunked of the dense slices);
   the fused round on phase 4's run()'s own states, round by round, with
   run()'s top-k selections imposed: every row whose own choice differs a
   near-tie, and the round equal in value to c2dfb_round with the
   exchange's mixes (shift by shift, sum w (hat_j - hat_i)); kernel_quant on a
   torch.Generator, T = 1 (B4 40, the closed-form bytes); on m = 4, ring and
   star, dense and fused, and make_sharded_inner_loop, card against host.
   The fused and dense rounds at this width and the four small ones are
   metered: each round's collective bytes a device (what one rank receives
   through the shifts and gathers, the reference's HLO count) equal to the
   closed form device_collective_bytes (and card to host on the small
   ones), the fused below the dense at this width, and each path's
   roofline terms (launch.roofline.roofline_terms) with the card's name
   and power limit.
   B2 and B3 (its tile entry against zeros().scatter_add_, its leaf entry
   onto a base against today's three calls: the tile, the slice and the
   add) are held bit for bit and timed at the exchange's stacked shapes with
   phase 3.  The profiled round counts B3 by every kernel name it has and
   prints its strided copies and adds;
12. the dense LM bilevel run: C2DFB on phi3-mini-3.8b at its published
   width, 2 of 32 layers, bf16 leaves, m = 4 on a ring, B = 4, S = 128,
   K = 5 through run(): kernel_topk, T = 3 (B1 bf16 2 x 4*K a round, the
   most survivors in a block, a profiled warm round, the peak memory),
   kernel_quant, T = 2 (B4 bf16), the wire bytes (B2), the fused exchange
   at full width (its round metered: collective bytes a device equal to the
   closed form, printed beside the dense exchange's closed form and both
   roofline terms), phi3-smoke fused against dense bit for bit (each
   round's collective bytes the closed form), and lm-test card against
   host round by round;
13. the MoE, Mamba-2 and multimodal paths: C2DFB on mamba2-2.7b at its
   published width, 2 of 64 layers, its f32 a_log, d_skip and dt_bias
   beside bf16 leaves, with phase 12's traffic through run(): kernel_topk,
   T = 3 (B1 bf16 2 x 4*K a round, none in f32: x is mixed uncompressed;
   every leaf at its dtype, a profiled warm round, the peak memory),
   kernel_quant, T = 2 (B4 bf16), the wire bytes (B2); one mixtral-8x7b
   block at full width (loss and gradient, the slots dropped at capacity
   160 against the host's count, the dispatch against the direct top-2
   mixture); seamless-m4t-medium at full depth and llama-3.2-vision-11b at
   one repeat (loss and gradient through the memory, the encoder's
   gradient, the memory's reach); one full-width Mamba-2 layer over two
   chunks and jamba-smoke, mixtral-smoke and mamba2-smoke, one round each,
   card against host;
14. the step factories, optimizers, checkpoints and the train and serve
   CLIs (A10c), each CLI through its main(argv) in process, every run's wall
   time and peak memory printed with the card: serve gemma2-27b at its
   published width and full depth (46 layers, B = 2, a prompt of 4,096 =
   its window, 16 tokens), the prefill and the first 4 decode steps within
   4 bf16 steps of a forward over the prompt and the tokens so far;
   phi3-mini-3.8b served at full depth (B = 4, 64 + 32 tokens), every
   decode step so; phi3-mini trained 3 AdamW steps at full width and depth
   (B = 4, S = 128: finite losses, every leaf moved, the peak, each step's
   loss and gradient, clip and update by CUDA events); phi3-smoke trained
   with --ckpt-dir and the checkpoint loaded back on the card bit for bit,
   zlib's rate on a 100 MB bf16 leaf; the c2dfb CLI on qwen2-smoke with
   kernel_topk (B1 bf16 2 x 4 K x 2 = 48 launches, none f32; the wire bytes
   of the host's run); and f32 phi3-, gemma2-, mamba2- and mixtral-smoke
   (and phi3-smoke in bf16) card against host: a SGD-M step, the prefill and
   8 decode steps;
15. launch planning: the dry run through dryrun.main(argv) at full width on
   the fake 256- and 512-rank meshes, rank 0 of a 16 x 16 train step run
   for real against the dry run's peak, and the host mesh;
16. the nine examples' twins (examples/*_torch.py) through their
   main(argv) in process at their own sizes (coefficient tuning and
   hyper-representation with --fast; the LM example at its 20m preset),
   artifacts in a temporary directory: each returns, observability's own
   asserts hold, each twin's wall is printed, and its kernel launches are
   counted (no kernel of this repo is on their path: every example
   compresses with top-k, metered by the host's sparse codec, so each
   count must be 0); wan_bilevel and transport_backends also run on the
   host first, and the card's run prints the same integers, and the same
   floats within the golden tolerance up to the first top-k near-tie: the
   card's selections are compared with the host's (selection.compared),
   every compressed residual up to the first parting must lie within the
   golden tolerance of the host's and the parting must be a near-tie, and
   the printed floats (all printed after the last round) are held only if
   the runs never part (examples/_compare_torch.py).  Keeping the
   host's selections instead does not hold: wan_bilevel's residuals drift
   apart by rounding on the same coordinates (1e-3 after 380 of its 3,604
   compressions) and the card's run, on selections made for another
   trajectory, goes to NaN.

The last lines are a {"kernels": [...]} record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode

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


def device_window(fn, iters: int, cpu: bool = True):
    """Run ``fn`` ``iters`` times under torch.profiler (host operators too
    unless ``cpu`` is False); returns the device activity it saw (kernels,
    memsets, copies), the host wall seconds of the calls (between device
    synchronizations inside the profiled window, so the profiler's own
    start and stop are left out) and the host operators' names with their
    counts."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops = collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CPU)
    return events, wall, ops


def busy_us(events) -> float:
    """Microseconds the device was busy: the union of the activities'
    intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Mean device milliseconds a call: the summed duration of the device
    activity the profiler (CUPTI) saw over ``iters`` calls.  None when it saw
    none, or when its records are incomplete: every activity of one
    profiled call must appear exactly ``iters`` times as often over the
    ``iters`` calls, since a sum over a profiler that dropped records
    under-reports the time."""
    import collections

    for _ in range(warmup):
        fn()
    one, _, _ = device_window(fn, 1)
    events, _, _ = device_window(fn, iters)
    per_call = collections.Counter(e.name for e in one)
    seen = collections.Counter(e.name for e in events)
    complete = bool(per_call) and seen == collections.Counter({n: c * iters for n, c in per_call.items()})
    us = sum(e.time_range.elapsed_us() for e in events)
    print(f"[timer] {len(events)} device activities over {iters} calls, {sum(per_call.values())} in one "
          f"({'complete' if complete else 'INCOMPLETE: CUDA events instead'}): "
          f"{sorted({e.name[:40] for e in events})[:4]}")
    return us / 1e3 / iters if complete and us > 0 else None


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
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


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


# blocks of the unpack kernel's edge records: EDGE_BLOCKS and the largest
# block it takes, whose one row a CTA needs dynamic shared memory above 48 KB
UNPACK_BLOCKS = EDGE_BLOCKS + (12288,)


def edge_records(rows: int, block: int, gen, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, kpad) records, kpad = padded_k(round(0.2 * block)): kpad / 2
    survivors a row on distinct lanes below block - 8, ascending, then
    edge slots: a duplicate of slot 0's lane (two values sum), -1,
    INT_MIN, block and block + 5 (ignored), a NaN on lane block - 2, -0.0
    on lane block - 1 (lanes of their own), +inf on lane block - 3; the
    rest 0.0 at the sentinel, one holding 9.0 (it must write nothing)."""
    from repro_torch.kernels.pack_residuals import padded_k

    kpad = padded_k(int(round(0.2 * block)))
    n = kpad // 2
    lanes = torch.rand((rows, block - 8), generator=gen, device=dev).argsort(dim=1)[:, :n].sort(dim=1).values
    vals = torch.zeros((rows, kpad), device=dev)
    idx = torch.full((rows, kpad), block, dtype=torch.int32, device=dev)
    vals[:, :n] = torch.randn((rows, n), generator=gen, device=dev)
    idx[:, :n] = lanes.to(torch.int32)
    edges = [(0.75, None), (5.0, -1), (6.0, -(2**31)), (7.0, block), (8.0, block + 5),
             (float("nan"), block - 2), (-0.0, block - 1), (float("inf"), block - 3), (9.0, block)]
    for j, (v, i) in enumerate(edges):
        vals[:, n + j] = v
        idx[:, n + j] = idx[:, 0] if i is None else i
    return vals, idx


def unpack_edges(dev, gen) -> int:
    """B3's tile entry and its leaf entry on edge records at every
    UNPACK_BLOCKS block, bit for bit (NaN positions equal) against their
    plain versions: the leaf in f32 and bf16, 3 ranks of d = 3 * block,
    2 * block + 100 and 2 * block + 101 (d % block != 0; d % 8 == 4 and
    d % 4 == 1 put ranks' rows off the 16-byte boundary), without a base and
    onto a base holding -0.0 on every third value (an empty lane gives +0.0
    there).  Returns the number of cases checked."""
    from repro_torch.kernels.pack_residuals import (
        unpack_sparse_blocks,
        unpack_sparse_blocks_into,
        unpack_sparse_blocks_into_ref,
        unpack_sparse_blocks_ref,
    )

    cases = 0
    for block in UNPACK_BLOCKS:
        vals, idx = edge_records(12, block, gen, dev)
        got = unpack_sparse_blocks(vals, idx, block)
        torch.cuda.synchronize()
        check(same(got, unpack_sparse_blocks_ref(vals, idx, block)), f"unpack tile block {block}: edge records")
        cases += 1
        for d in (3 * block, 2 * block + 100, 2 * block + 101):
            nb = -(-d // block)
            v, i = vals[: 3 * nb], idx[: 3 * nb]
            for dt in (torch.float32, torch.bfloat16):
                base = torch.randn((3, d), generator=gen, device=dev).to(dt)
                base.view(-1)[::3] = -0.0
                for b in (None, base):
                    got = unpack_sparse_blocks_into(v, i, base, block, base=b)
                    want = unpack_sparse_blocks_into_ref(v, i, base, block, base=b)
                    torch.cuda.synchronize()
                    what = f"unpack leaf block {block} d {d} {dt} {'onto a base' if b is not None else 'alone'}"
                    check(got.dtype == dt and got.shape == (3, d), f"{what}: {got.dtype} {tuple(got.shape)}")
                    check(same(got, want), f"{what} differs from its plain version")
                    check(b is None or not torch.signbit(got[got == 0]).any(), f"{what}: a -0.0 base stayed -0.0")
                    cases += 1
    print(f"[kernels] unpack edge records: {cases} cases at blocks {UNPACK_BLOCKS} (tile; leaf f32 and bf16, "
          f"d % block != 0, d % 4 != 0, with and without a base), bit-exact against the plain versions")
    return cases


# the instance of each kernel that the main path's shapes launch
MAIN_INSTANCES = {
    "block_topk": "warp_topk_kernel<float, 32, 32>",
    "pack_sparse_blocks": "pack_kernel",
    "unpack_sparse_blocks": "unpack_kernel<float, false>",
    "unpack_sparse_blocks_into": "unpack_kernel<float, true>",
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
    unpack_edges(dev, gen)
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
    count exactly 4*K*T launches.  Returns the final state, config, topology,
    every launch counter of the run and its metrics."""
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
    return state, cfg, topo, counts, mets


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
    busy = busy_us(events)
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


#: seconds a round of each counted async run of phase 8, by its tag
ASYNC_WALLS: dict[str, float] = {}


def _async_run(tag: str, fn, T_: int):
    """Run ``fn()`` with the launch counts set to 0 just before and read
    just after; prints its wall time, per-round wall time and peak device
    memory (the seconds a round also go to ASYNC_WALLS).  Returns (result,
    launch counts)."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    ASYNC_WALLS[tag] = wall / T_
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
    busy = busy_us(events)
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


# ---------------------------------------------------------------- phase 10: the compiled runtime


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (a NaN equals a NaN of the same bits)."""
    if torch.is_tensor(a):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        return torch.equal(bits(a), bits(b)) if a.is_floating_point() else torch.equal(a, b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_run(tag: str, got, want) -> None:
    """A compiled run against its eager twin: state, every metric and the
    ledger (ages, loop seconds, the consensus curve) bit for bit."""
    from repro_torch.async_gossip.compiled import _tensors

    (sg, mg), (sw, mw) = got, want
    check(all(_same_bits(a, b) for a, b in zip(_tensors(sg), _tensors(sw))) and sg.t == sw.t,
          f"{tag}: the compiled state differs from the eager run's")
    check(set(mg) == set(mw), f"{tag}: metric keys {sorted(mg)} against {sorted(mw)}")
    for k in mw:
        if k != "ledger":
            check(_same_bits(mg[k], mw[k]), f"{tag}: metric {k} differs from the eager run's")
    lg, lw = mg["ledger"], mw["ledger"]
    check(len(lg.loops) == len(lw.loops) and all(
        np.array_equal(a.ages, b.ages) and (a.t_start, a.t_end) == (b.t_start, b.t_end)
        for a, b in zip(lg.loops, lw.loops)), f"{tag}: the ledger's loops differ")
    check(all(_same_bits(a, b) for a, b in zip(lg.curve(), lw.curve())), f"{tag}: the ledger's curve differs")


def kernel_counts(fn):
    """``fn()`` under torch.profiler; returns its result, the launches of B1
    (block top-k) and B4 (the quantizer) counted from the kernel records'
    names, which CUPTI reports for the kernels of a replayed graph too, and
    the count of all device activity records."""
    out = []
    events, _, _ = device_window(lambda: out.append(fn()), 1, cpu=False)
    names = [e.name for e in events]
    return out[0], {"block_topk": sum("topk_kernel" in n for n in names),
                    "quantize": sum("quant_kernel" in n for n in names)}, len(events)


def _timed_run(fn):
    """(result, wall seconds, peak device memory above what was allocated
    before the call) of ``fn()``: the run's own high-water mark, whatever
    earlier results are still held."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - held


@contextlib.contextmanager
def replay_loop(sync_debug: bool = False, profiled: bool = False):
    """Wrap the compiled runtime's phase 2 (`RoundGraphs.run`: eager
    warm-ups, captures and replays) for the runs inside the block: under
    ``torch.cuda.set_sync_debug_mode("error")``, where a host sync raises,
    or profiled (the yielded dict gets the loop's wall seconds and the
    device's busy microseconds)."""
    from repro_torch.async_gossip.compiled import RoundGraphs

    run, seen = RoundGraphs.run, {}

    def wrapped(self, *args, **kwargs):
        if profiled:
            out = []
            events, seen["wall"], _ = device_window(lambda: out.append(run(self, *args, **kwargs)), 1, cpu=False)
            seen["busy_us"], seen["activities"] = busy_us(events), len(events)
            return out[0]
        torch.cuda.set_sync_debug_mode("error" if sync_debug else 0)
        try:
            return run(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    RoundGraphs.run = wrapped
    try:
        yield seen
    finally:
        RoundGraphs.run = run


def phase_compiled(dev, bundle) -> dict:
    """The compiled runtime: a scheduler replay with analytic sizes, then
    each branch's round body captured once in a CUDA graph and replayed.

    (a) At TASK's width on phase 8's fabric, each run compiled, then eager
    with analytic payloads: sync, bounded 1 and full (T = 3); the composed
    run (acked, inverse-age damping, dropout, a JSONL sink; T = 3);
    kernel_quant bounded 1 (T = 2); async MDBO and MADSBO bounded 1 (T = 2,
    steps 1e-3).  Each compiled run equals its eager twin bit for bit
    (state, every metric, the ledger; the composed run's records too) and
    captures at most one graph a branch (the composed run exactly one); a
    second, profiled compiled run of each C2DFB config launches B1
    (kernel_topk) or B4 (kernel_quant) 4*K*T times.  Prints the captures,
    the peak device memory against the eager twin's and the seconds a
    round of eager measured (phase 8), eager analytic and compiled.

    (b) At the compiled axis's config of the reference's async benchmark
    (benchmarks/bench_async.py: m = 10, K = 6, n = 500, p = 30, c = 5, topk
    at 0.5, ring), T = 50, for sync, bounded 1 and full: eager (measured
    and analytic), compiled cold and warm through one fn_cache (equal to
    eager analytic bit for bit), and the speed-up; the captures equal at
    T = 25 and T = 50; a warm run's replay loop under
    set_sync_debug_mode("error"), and another profiled for the device's
    idle share in the loop.

    (c) A compiled bounded-1 run on er(10, 0.4), on the card and on the
    host: states within TOL, the integers and seconds equal.

    Returns the profiled B1 and B4 counts of (a)'s kernel_topk bounded-1
    and kernel_quant runs."""
    import tempfile

    from repro_torch.async_gossip import (
        graph_captures, reset_graph_captures, run_async, run_async_compiled, run_baseline_async,
    )
    from repro_torch.async_gossip import engine as E
    from repro_torch.core import baselines as B
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import ring
    from repro_torch.net import LinkDropoutSchedule, make_fabric
    from repro_torch.obs import JsonlSink, Obs, parity_rows, read_jsonl

    K = CFG["K"]
    problem, x0, y0 = bundle.problem, bundle.x0, bundle.y0
    topo = ring(TASK["m"])
    tmp = tempfile.TemporaryDirectory()

    def c2dfb(cfg_kw, T_, gen_seed=None, jsonl=False, **kw):
        """make(eager, cache) of a C2DFB run at TASK's width on the geo
        fabric (``cache``: the compiled run's fn_cache).  Every run of a
        stochastic config draws from one generator, seeded anew: the graphs
        of a cached run replay the generator they registered."""
        source = None if gen_seed is None else torch.Generator(device=dev)

        def make(eager, cache=None):
            def fn():
                gen = None if source is None else source.manual_seed(gen_seed)
                extra = dict(kw)
                if jsonl:
                    extra["schedule"] = LinkDropoutSchedule(topo, **DROPOUT)
                    extra["obs"] = Obs(sink=JsonlSink(f"{tmp.name}/{'eager' if eager else 'compiled'}.jsonl"))
                args = (problem, topo, C2DFBConfig(**cfg_kw), x0, y0, T_, gen, make_fabric(topo, **GEO))
                res = (run_async(*args, payload_bytes="analytic", device=dev, **extra) if eager
                       else run_async_compiled(*args, fn_cache=cache, device=dev, **extra))
                if jsonl:
                    extra["obs"].close()
                return res
            return fn
        return make

    def baseline(alg, bcfg):
        return lambda eager, cache=None: lambda: run_baseline_async(
            alg, problem, topo, bcfg, x0, y0, 2, make_fabric(topo, **GEO), policy="bounded", bound=1,
            compiled=not eager, fn_cache=cache, device=dev)

    runs = [  # (tag, T, make(eager) -> fn, the kernel counted, phase 8's eager measured run)
        ("sync", T, c2dfb(CFG, T, policy="sync"), "block_topk", "sync"),
        ("bounded1", T, c2dfb(CFG, T, policy="bounded", bound=1), "block_topk", "bounded1"),
        ("full", T, c2dfb(CFG, T, policy="full"), "block_topk", "full"),
        ("composed", T, c2dfb(CFG, T, jsonl=True, policy="bounded", bound=1, version_rule="acked",
                              mixing_damping="inverse-age"), None, "bounded1 acked inverse-age dropout obs"),
        ("kernel_quant bounded1", 2, c2dfb(CFG_QUANT, 2, gen_seed=0, policy="bounded", bound=1), "quantize", None),
        ("mdbo bounded1", 2, baseline("mdbo", B.MDBOConfig(neumann_eta=1e-3)), None, "mdbo bounded1"),
        ("madsbo bounded1", 2, baseline("madsbo", B.MADSBOConfig(eta_v=1e-3)), None, "madsbo bounded1"),
    ]
    counted = {}
    for tag, T_, make, kernel, measured_tag in runs:
        probes = len(E._ANALYTIC_BYTES_CACHE)
        want, wall_e, peak_e = _timed_run(make(True))
        cache: dict = {}
        reset_graph_captures()
        got, wall_c, peak_c = _timed_run(make(False, cache))
        captures, probe = graph_captures(), len(E._ANALYTIC_BYTES_CACHE) - probes
        warm, wall_w, _ = _timed_run(make(False, cache))
        check(graph_captures() == captures, f"{tag}: the warm run captured again")
        del cache
        _same_run(tag, got, want)
        _same_run(f"{tag} (warm)", warm, want)
        _finite(f"compiled {tag}", *got)
        n_capt = sum(captures.values())
        check(n_capt <= 2 and all(v == 1 for v in captures.values()), f"{tag}: captures {captures}")
        if tag == "composed":
            check(n_capt == 1, f"composed: captures {captures}, want exactly 1")
            recs = {k: read_jsonl(f"{tmp.name}/{k}.jsonl") for k in ("compiled", "eager")}
            for kind, n in (("round", T_), ("node", T_ * TASK["m"])):
                rows = [parity_rows(r, kind=kind) for r in recs.values()]
                check(rows[0] == rows[1] and len(rows[0]) == n, f"composed: the {kind} records differ")
        line = (f"[compiled] {tag}: captures {captures}; peak device memory above what the run found allocated "
                f"{peak_c} B compiled, {peak_e} B eager analytic; s a round: eager measured {ASYNC_WALLS.get(measured_tag)!r}, eager analytic "
                f"{wall_e / T_!r}, compiled cold {wall_c / T_!r} (bodies built and captured in the run), warm "
                f"{wall_w / T_!r} (graphs replayed from the first run's fn_cache); the analytic probe ran {probe}x")
        if kernel is not None:
            # two profiled cold runs: the profiler has been seen to miss 2 of
            # the 120 B1 records of such a run on an H100 (its results
            # bit-equal, so the kernels ran); one run must count exactly and
            # neither more
            seen = []
            for _ in range(2):
                again, counts, records = kernel_counts(make(False))
                _same_run(f"{tag} (profiled)", again, want)
                seen.append((counts[kernel], records, counts))
                del again
            (n1, r1, _), (n2, r2, _) = seen
            want_n = 4 * K * T_
            check(max(n1, n2) == want_n,
                  f"{tag}: the profiler saw {n1} and {n2} {kernel} launches in {r1} and {r2} device records, "
                  f"want 4*K*T = {want_n}")
            line += (f"; two profiled cold runs launched {seen[0][2]} and {seen[1][2]} in {r1} and {r2} device "
                     f"records (4*K*T = {want_n})")
            counted[tag] = max(seen)[2]
        print(line)
        del got, want, warm
    tmp.cleanup()
    phase_compiled_small(dev)
    phase_compiled_host(dev)
    return {"block_topk": counted["bounded1"]["block_topk"], "quantize": counted["kernel_quant bounded1"]["quantize"]}


# the compiled axis of the reference's async benchmark (benchmarks/bench_async.py:255-300)
SMALL_COMPILED_TASK = dict(m=10, n=500, p=30, c=5, h=0.8, seed=0)
SMALL_COMPILED_CFG = dict(lam=10.0, eta_out=0.3, gamma_out=0.5, eta_in=0.3, gamma_in=0.3, K=6, compressor="topk",
                          comp_ratio=0.5)


def phase_compiled_small(dev) -> None:
    """(b) of `phase_compiled`."""
    from repro_torch.async_gossip import graph_captures, reset_graph_captures, run_async, run_async_compiled
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import ring
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.net import make_fabric

    b = coefficient_tuning_task(**SMALL_COMPILED_TASK, device=dev)
    topo, cfg = ring(SMALL_COMPILED_TASK["m"]), C2DFBConfig(**SMALL_COMPILED_CFG)
    Tb = 50

    def go(T_, policy, bound, mode=None, cache=None):
        args = (b.problem, topo, cfg, b.x0, b.y0, T_, None, make_fabric(topo, **GEO))
        if mode is not None:
            return run_async(*args, policy=policy, bound=bound, payload_bytes=mode, device=dev)
        return run_async_compiled(*args, policy=policy, bound=bound, fn_cache=cache, device=dev)

    go(2, "bounded", 1, "analytic")  # traces the oracles at this config
    for policy, bound in (("sync", 0), ("bounded", 1), ("full", 0)):
        tag = f"{policy}{bound if policy == 'bounded' else ''}"
        measured, w_meas, _ = _timed_run(lambda: go(Tb, policy, bound, "measured"))
        analytic, w_ana, _ = _timed_run(lambda: go(Tb, policy, bound, "analytic"))
        cache: dict = {}
        reset_graph_captures()
        cold, w_cold, _ = _timed_run(lambda: go(Tb, policy, bound, cache=cache))
        capt = graph_captures()
        warm, w_warm, _ = _timed_run(lambda: go(Tb, policy, bound, cache=cache))
        check(graph_captures() == capt, f"small {tag}: the warm run captured again ({graph_captures()})")
        for what, r in (("cold", cold), ("warm", warm)):
            _same_run(f"small {tag} compiled {what}", r, analytic)
        with replay_loop(sync_debug=True):
            guarded = go(Tb, policy, bound, cache=cache)
        _same_run(f"small {tag} under sync debug", guarded, analytic)
        with replay_loop(profiled=True) as seen:
            go(Tb, policy, bound, cache=cache)
        by_T = {}
        for T_ in (25, 50):
            reset_graph_captures()
            go(T_, policy, bound, cache={})
            by_T[T_] = graph_captures()
        check(by_T[25] == by_T[50] and sum(by_T[50].values()) <= 2, f"small {tag}: captures {by_T}")
        busy = seen["busy_us"] / 1e6
        print(f"[compiled small] {tag}, T = {Tb}: wall eager measured {w_meas!r} s, eager analytic {w_ana!r} s, "
              f"compiled cold {w_cold!r} s, warm {w_warm!r} s; speed-up of warm compiled over eager analytic "
              f"{w_ana / w_warm!r}x, over eager measured {w_meas / w_warm!r}x; captures {by_T[25]} at T = 25, "
              f"{by_T[50]} at T = 50; a warm replay loop ran under set_sync_debug_mode('error'); profiled warm "
              f"replay loop (device activity only): wall {seen['wall']!r} s, device busy {busy!r} s, idle share "
              f"{1 - busy / seen['wall']!r}, {seen['activities']} device activities; staleness_max "
              f"{sorted(set(int(a) for a in warm[1]['staleness_max']))}")
        del measured, analytic, cold, warm, guarded


def phase_compiled_host(dev) -> None:
    """(c) of `phase_compiled`: a compiled bounded-1 run on er(10, 0.4) with
    the geo fabric, card against host."""
    from repro_torch.async_gossip import graph_captures, reset_graph_captures, run_async_compiled
    from repro_torch.async_gossip.compiled import _tensors
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import make_topology
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.net import make_fabric

    topo = make_topology("er", 10, p=0.4, seed=0)
    cfg = C2DFBConfig(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    out = {}
    for d in ("cpu", dev):
        b = coefficient_tuning_task(m=10, n=400, p=64, c=4, seed=0, device=d)
        reset_graph_captures()
        out[d] = run_async_compiled(b.problem, topo, cfg, b.x0, b.y0, 5, fabric=make_fabric(topo, **GEO),
                                    policy="bounded", bound=1, device=d)
    (sc, mc), (sg, mg) = out["cpu"], out[dev]
    for la, lb in zip(_tensors(sc), _tensors(sg)):
        check(torch.allclose(lb.cpu(), la, **TOL), "small compiled run: the card's state differs from the host's")
    for k in ("sim_seconds", "wire_bytes", "staleness_max", "staleness_mean", "staleness_hist"):
        check(np.array_equal(mc[k], mg[k]), f"small compiled run: {k} differs between card and host")
    check(torch.equal(mc["measured_bytes"], mg["measured_bytes"].cpu()), "small compiled run: measured_bytes differ")
    check(all(np.array_equal(a.ages, b.ages) for a, b in zip(mc["ledger"].loops, mg["ledger"].loops)),
          "small compiled run: ages differ between card and host")
    print(f"[compiled small] bounded 1 on er(10, 0.4), T = 5: card and host agree (rtol {TOL['rtol']}, atol "
          f"{TOL['atol']}; integers equal); card captures {graph_captures()}, wire_bytes {mg['wire_bytes'].tolist()}, "
          f"measured_bytes {mg['measured_bytes'].tolist()}")


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


# ---------------------------------------------------------------- phase 11: the transports


def _recording_meter(transport) -> list:
    """Keep each round's per-phase node bytes of ``transport``'s metering:
    returns the list its wrapped ``meter_round`` appends them to."""
    reports = []
    meter = transport.meter_round

    def recording(*args, **kw):
        rep = meter(*args, **kw)
        reports.append(rep["node_bytes"])
        return rep

    transport.meter_round = recording
    return reports


def collectives_report(tag: str, cost, closed: float, m: int, smi: str, note: str = "") -> dict:
    """One device-transport path's round cost as the reference's bench_lm
    reports it: ``collective_bytes`` a device (counted on the metered round
    0, ``DeviceTransport.cost``) checked equal to the closed form
    `device_collective_bytes`, and ``roofline_terms(flops, hbm_bytes,
    collective_bytes, chips=m)``, printed with the card's name and power
    limit.  Returns the bytes and the terms."""
    from repro_torch.launch.roofline import roofline_terms

    got = cost.collective_bytes
    check(isinstance(got, float) and got == closed, f"{tag}: collective_bytes {got!r}, the closed form {closed!r}")
    terms = roofline_terms(cost.flops, cost.hbm_bytes, got, chips=m)
    print(f"[collectives] {tag}: collective_bytes {got!r} a device a round (closed form {closed!r}){note}; flops "
          f"{cost.flops!r}, hbm_bytes {cost.hbm_bytes!r} a device; roofline_terms {terms}; {smi}")
    return dict(collective_bytes=got, roofline=terms)


def _transport_run(dev, bundle, transport, cfg_kw: dict, T_: int, generator=None, obs=None) -> dict:
    """``run(transport=)`` at TASK's width on the ring: the state, the
    metrics, the launch counts, each round's per-phase node bytes, the wall
    seconds and the peak device memory above what was held before.  With
    ``obs``, round 0 is metered (``transport.cost``)."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.kernels import _build

    reports = _recording_meter(transport)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, mets = run(bundle.problem, ring(TASK["m"]), C2DFBConfig(**cfg_kw), bundle.x0, bundle.y0, T=T_,
                      generator=generator, device=dev, transport=transport, obs=obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(state=state, mets=mets, counts=_build.launch_counts(), reports=reports, wall=wall,
                peak=torch.cuda.max_memory_allocated() - held)


def _check_transport_run(tag: str, out: dict, cfg_kw: dict, T_: int) -> None:
    """Finite results of the right shapes; each round's wire bytes are the
    degree-weighted sum of its node bytes and its measured bytes the inner
    node bytes plus the dense outer term; prints each round's seconds."""
    from repro_torch.core.topology import ring

    m, p = TASK["m"], TASK["p"]
    deg = [len(n) for n in ring(m).neighbors]
    state, mets = out["state"], out["mets"]
    for leaf in (state.x, state.s_x, state.inner_y.d, state.inner_z.d):
        check(bool(torch.isfinite(leaf).all()), f"{tag}: the state holds non-finite values")
    check(tuple(state.inner_y.d.shape) == (m, p, TASK["c"]), f"{tag}: y has the wrong shape")
    for k, v in mets.items():
        check(v.shape[0] == T_ and bool(np.isfinite(v.astype(np.float64)).all()), f"{tag}: metric {k} is {v}")
    check(len(out["reports"]) == T_ and all(len(r) == 2 + 4 * cfg_kw["K"] for r in out["reports"]),
          f"{tag}: the meter priced {[len(r) for r in out['reports']]} phases a round")
    for t, nb in enumerate(out["reports"]):
        wire = sum(d * b for v in nb.values() for d, b in zip(deg, v))
        inner = sum(sum(v) for label, v in nb.items() if not label.startswith("out/"))
        check(wire == int(mets["wire_bytes"][t]), f"{tag} round {t}: wire_bytes {mets['wire_bytes'][t]}, "
              f"the node bytes sum to {wire}")
        check(inner + 2 * p * 4 * m == int(mets["measured_bytes"][t]), f"{tag} round {t}: measured_bytes")
        print(f"{tag} round {t}: wall {float(mets['wall_seconds'][t])!r} s, meter {float(mets['meter_seconds'][t])!r} s,"
              f" sim_seconds {float(mets['sim_seconds'][t])!r}, wire_bytes {int(mets['wire_bytes'][t])}, "
              f"measured_bytes {int(mets['measured_bytes'][t])}, hypergrad_norm {float(mets['hypergrad_norm'][t])!r}")
    print(f"{tag} {T_} rounds in {out['wall']!r} s, launches {out['counts']}, peak device memory "
          f"{out['peak']} bytes above what was held before the run")


def profile_device_round(bundle, state, transport) -> None:
    """One more fused round body from ``state`` (no metering), warm, then
    profiled: its wall, the device busy share, the launches by kernel name
    (B1 4*K, B2 4*K, B3 3 * 4*K on the ring, every one of them the leaf
    entry onto a base, by each name B3 has), the strided elementwise kernels
    (copies into or out of a slice, ops that read one) and the adds.  The
    unpack's slice to the leaf and its add are gone: no strided add runs,
    and no more strided copies than the 4*K packs' pads."""
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import ring
    from repro_torch.transport import make_device_round

    K = CFG["K"]
    round_fn = make_device_round(bundle.problem, ring(TASK["m"]), C2DFBConfig(**CFG), transport.mesh, fused=True)
    args = (state.x, state.s_x, state.u_prev, state.inner_y, state.inner_z, None)
    round_fn(*args)
    events, wall, _ = device_window(lambda: round_fn(*args), 1)
    busy = busy_us(events)
    names = [e.name for e in events]
    launches = {k: sum(pat in n for n in names)
                for k, pat in (("topk_kernel", "topk_kernel"), ("pack_kernel", "::pack_kernel"),
                               ("unpack_kernel", "::unpack_kernel"))}
    b3 = {}
    for n in names:
        if "::unpack_kernel" in n:
            key = n[n.index("unpack_kernel"):].split("(")[0]
            b3[key] = b3.get(key, 0) + 1
    # PyTorch runs an elementwise op over a non-contiguous operand (a copy
    # out of a slice, or an add that reads one) as elementwise_kernel<...>,
    # a contiguous one as vectorized_ or unrolled_elementwise_kernel
    strided = [n for n in names if n.startswith("void at::native::elementwise_kernel<")]
    adds = [n for n in names if "CUDAFunctor_add" in n]
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    print(f"[transport] profiled fused round body: wall {wall!r} s, device busy {busy / 1e6!r} s "
          f"({busy / 1e6 / wall:.3f} of the wall), {len(events)} device activities, launches {launches}; "
          f"B3 by kernel name {b3}; strided elementwise kernels {len(strided)} "
          f"({sum(by_name[n][0] for n in set(strided)) / 1e3:.3f} ms; copies "
          f"{sum('copy_kernel' in n for n in strided)}, adds {sum('add' in n.lower() for n in strided)}), "
          f"adds in all {len(adds)} ({sum(by_name[n][0] for n in set(adds)) / 1e3:.3f} ms)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[transport]   {us / 1e3:10.3f} ms  {n:5d}x  {name[:90]}")
    for name in sorted(set(strided)):
        print(f"[transport]   strided {by_name[name][1]}x {by_name[name][0] / 1e3:.3f} ms: {name[:300]}")
    check(launches == {"topk_kernel": 4 * K, "pack_kernel": 4 * K, "unpack_kernel": 3 * 4 * K},
          f"a fused round launched {launches}")
    check(b3 == {"unpack_kernel<float, true>": 3 * 4 * K}, f"a fused round's B3 launches by name: {b3}")
    strided_adds = sum("add" in n.lower() for n in strided)
    strided_copies = sum("copy_kernel" in n for n in strided)
    check(strided_adds == 0 and strided_copies <= 4 * K, f"a fused round ran {strided_adds} strided adds and "
          f"{strided_copies} strided copies: the unpack's slice or add is back (the pads of 4*K packs copy)")


def transport_kernel_times(dev) -> dict:
    """B2 and B3 at the fused exchange's stacked shapes (every rank's blocks
    of a leaf in one launch: (m * nb, block) tiles of B1's output, packed
    to kpad records), each bit for bit against its plain version and timed
    beside its bound and a copy_ of its bytes: B3's tile entry beside
    zeros().scatter_add_; its leaf entry, straight into the (m, p, c) leaf,
    onto a base in f32 (the fused exchange's call) and bf16 and alone in
    f32, beside today's three calls (the tile, the slice to the leaf and the
    add).  Returns B2's and B3's tile entries, and the leaf entry's record."""
    from repro_torch.kernels.pack_residuals import (
        pack_sparse_blocks,
        pack_sparse_blocks_ref,
        padded_k,
        unpack_sparse_blocks,
        unpack_sparse_blocks_into,
        unpack_sparse_blocks_into_ref,
        unpack_sparse_blocks_ref,
    )
    from repro_torch.kernels.topk_compress import block_topk_kernel

    m, p, c, block = TASK["m"], TASK["p"], TASK["c"], CFG["comp_block"]
    nb = -(-p * c // block)
    rows = m * nb
    k = max(1, int(round(CFG["comp_ratio"] * block)))
    kpad = padded_k(k)
    gen = torch.Generator(device=dev).manual_seed(1)
    q = block_topk_kernel(torch.randn((rows, block), generator=gen, device=dev), k)
    vals, idx = pack_sparse_blocks(q, kpad, block)
    rvals, ridx = pack_sparse_blocks_ref(q, kpad, block)
    back = unpack_sparse_blocks(vals, idx, block)
    rback = unpack_sparse_blocks_ref(vals, idx, block)
    torch.cuda.synchronize()
    check(torch.equal(bits(vals), bits(rvals)) and torch.equal(idx, ridx), "stacked pack differs from its plain version")
    check(torch.equal(back, q) and torch.equal(bits(back), bits(rback)), "stacked unpack(pack(q)) != q")
    nbytes = q.numel() * 4 + vals.numel() * 8
    idx64 = idx.to(torch.int64)
    lib = torch.zeros((rows, block + 1), device=dev).scatter_add_(1, idx64, vals)[:, :block]
    check(torch.equal(lib, back), "scatter_add_ yardstick disagrees with the stacked unpack")
    out = {
        "pack_sparse_blocks": dict(
            shape=[rows, block], kpad=kpad, max_abs_err=float((vals - rvals).abs().max()),
            **timed(lambda: pack_sparse_blocks(q, kpad, block)),
            plain_ms=timed(lambda: pack_sparse_blocks_ref(q, kpad, block), iters=3, warmup=1)["ms"],
            bound_ms=bound_ms(nbytes), bound_by="bytes", copy_ms=copy_ms(nbytes), library_ms=None,
        ),
        "unpack_sparse_blocks": dict(
            shape=[rows, kpad], block=block, max_abs_err=float((back - rback).abs().max()),
            **timed(lambda: unpack_sparse_blocks(vals, idx, block)),
            plain_ms=timed(lambda: unpack_sparse_blocks_ref(vals, idx, block), iters=3, warmup=1)["ms"],
            bound_ms=bound_ms(nbytes), bound_by="bytes", copy_ms=copy_ms(nbytes),
            library_ms=timed(lambda: torch.zeros((rows, block + 1), device=dev).scatter_add_(1, idx64, vals))["ms"],
        ),
    }
    for name, entry in out.items():
        print(f"[transport kernels] {name} at the stacked shape: {entry}")

    # B3's leaf entry: the records straight into the (m, p, c) leaf, onto a
    # base with -0.0 on every seventh value (the fused exchange's call), the
    # records carrying values that are not all bf16
    base = torch.randn((m, p, c), generator=gen, device=dev)
    base.view(-1)[::7] = -0.0
    rec = vals.numel() * 8
    leaf = {}
    for tag, b, with_base in (("f32", base, True), ("f32 alone", base, False),
                              ("bf16", base.to(torch.bfloat16), True)):
        kw = dict(base=b) if with_base else {}
        got = unpack_sparse_blocks_into(vals, idx, b, block, **kw)
        want = unpack_sparse_blocks_into_ref(vals, idx, b, block, **kw)

        def chain(b=b, with_base=with_base):  # today's three calls: the tile, the slice, the add
            dense = unpack_sparse_blocks(vals, idx, block).reshape(m, nb * block)[:, : p * c]
            dense = dense.reshape(b.shape).to(b.dtype)
            return b + dense if with_base else dense

        torch.cuda.synchronize()
        check(same(got, want), f"leaf entry {tag} at the stacked shape differs from its plain version")
        check(same(chain(), want), f"leaf entry {tag}: the three-call chain disagrees")
        leaf_bytes = rec + b.numel() * b.element_size() * (2 if with_base else 1)
        leaf[tag] = dict(
            shape=[m, p, c], dtype=str(b.dtype).removeprefix("torch."), base=with_base,
            max_abs_err=float((got.float() - want.float()).abs().nan_to_num().max()),
            **timed(lambda b=b, kw=kw: unpack_sparse_blocks_into(vals, idx, b, block, **kw)),
            plain_ms=timed(lambda b=b, kw=kw: unpack_sparse_blocks_into_ref(vals, idx, b, block, **kw),
                           iters=3, warmup=1)["ms"],
            bound_ms=bound_ms(leaf_bytes), bound_by="bytes", copy_ms=copy_ms(leaf_bytes),
            chain_ms=timed(chain)["ms"],
        )
        print(f"[transport kernels] unpack_sparse_blocks_into {tag} at the stacked shape: {leaf[tag]}")
        events, _, _ = device_window(chain, 1, cpu=False)
        print(f"[transport kernels]   its chain: {[e.name[:160] for e in events]}")
    main = leaf.pop("f32")
    out["unpack_sparse_blocks_into"] = dict(
        name="unpack_sparse_blocks_into", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/pack_residuals.cu",
        replaces="src/repro/kernels/pack_residuals.py:100",
        **main, library_ms=None,
        library="none: no single PyTorch call; chain_ms is today's tile + slice + add",
        alone=leaf["f32 alone"], bf16=leaf["bf16"],
    )
    return out


@contextlib.contextmanager
def exchange_mixes(topo):
    """Within the block, run()'s dense mixes (W - I) @ hat become the device
    exchange's, sum over the schedule's shifts of w (hat_j - hat_i) in f32
    (`repro_torch.core.gossip.mix_delta_shard`).  The two forms differ by
    more than their order: W - I in f32 has rows that sum to 5.96e-8, not
    0 (1/3 is not an f32, and 1/3 - 1 rounds), so each dense mix adds that
    multiple of hat_i, which the differences never carry."""
    from repro_torch.core import c2dfb, inner_loop
    from repro_torch.core.gossip import mix_delta_shard

    saved = c2dfb.mix_delta_dense, inner_loop.mix_delta_dense
    c2dfb.mix_delta_dense = inner_loop.mix_delta_dense = lambda W, x: mix_delta_shard(topo, x)
    try:
        yield
    finally:
        c2dfb.mix_delta_dense, inner_loop.mix_delta_dense = saved


def mix_forms_agree(topo, W: torch.Tensor, hat: torch.Tensor) -> float:
    """The exchange's mix of ``hat`` against run()'s dense one: they differ
    by the dense coefficients' row sums times hat_i, and by each one's
    rounding, at most 4 f32 epsilons of sum_j |(W - I)_ij| |hat_j| (a few
    roundings of each product and sum); a wrong weight or shift lies far
    outside.  Returns the largest difference as a share of that bound."""
    from repro_torch.core.gossip import mix_delta_dense, mix_delta_shard, w_minus_i

    L = w_minus_i(W)
    flat = hat.reshape(hat.shape[0], -1)
    diff = (mix_delta_shard(topo, hat) - mix_delta_dense(W, hat)).reshape(flat.shape).double()
    rho = L.double().sum(dim=1, keepdim=True)
    bound = rho.abs() * flat.double().abs() + 4 * torch.finfo(torch.float32).eps * (L.abs().double() @ flat.double().abs())
    share = float(((diff - rho * flat.double()).abs() - bound).max())
    check(share <= 0, f"the exchange's mix of a reference differs from the dense mix by more than the forms and "
          f"their rounding allow ({share!r} over)")
    return float(((diff.abs()) / (bound + 1e-300)).max())


def fused_on_run_states(dev, bundle, main_mets) -> None:
    """The fused device round on run()'s own round-t states, round by round
    (phase 4's run, stepped again: its hypergradient norms bit for bit
    run()'s).  run()'s round records every top-k selection; the fused round
    on the same state keeps them, and every row where its own choice
    differs must be a near-tie (`repro_torch.core.selection`: the two
    thresholds within the residuals' largest difference plus the
    bisection's resolution).  The same round through `c2dfb_round` with the
    exchange's mixes (`exchange_mixes`) and the same selections must equal
    the fused round in value, every state tensor: so the exchange (its
    copies, shifts, packs and unpacks) computes that round exactly, and the
    fused run parts from run() by the mixing form and the near-ties alone.
    Prints the parted rows, their largest relative k-th to (k+1)-th gap,
    and each field's largest distance between the fused round and
    run()'s."""
    from repro_torch.async_gossip.compiled import _tensors
    from repro_torch.core import selection
    from repro_torch.core.c2dfb import C2DFBConfig, c2dfb_round, init_state
    from repro_torch.core.topology import ring
    from repro_torch.transport import make_device_round, mesh_for_nodes

    topo, cfg = ring(TASK["m"]), C2DFBConfig(**CFG)
    problem = bundle.problem
    round_fn = make_device_round(problem, topo, cfg, mesh_for_nodes(TASK["m"], dev), fused=True)
    state = init_state(problem, cfg, bundle.x0, bundle.y0)
    seen, seen_ex = selection.Partings(), selection.Partings()
    names = ("x", "s_x", "u", "y", "y_hat", "y_s", "y_s_hat", "y_g", "z", "z_hat", "z_s", "z_s_hat", "z_g")
    for t in range(T):
        log = []
        with selection.recorded(log):
            want, mets = c2dfb_round(state, None, problem, topo, cfg)
        check(_same_bits(mets["hypergrad_norm"], main_mets["hypergrad_norm"][t]),
              f"round {t}: the stepped round is not run()'s round")
        W = torch.as_tensor(topo.W, dtype=torch.float32, device=state.x.device)
        for hat in (state.x, state.s_x, state.inner_y.d_hat, state.inner_y.s_hat, state.inner_z.d_hat,
                    state.inner_z.s_hat):
            mix_forms_agree(topo, W, hat)
        rows_before = seen.rows
        with selection.imposed(log, seen):
            got = round_fn(state.x, state.s_x, state.u_prev, state.inner_y, state.inner_z, None)[:5]
        with selection.imposed(log, seen_ex), exchange_mixes(topo):
            ex, _ = c2dfb_round(state, None, problem, topo, cfg)
        del log
        got, ex = _tensors(got), _tensors((ex.x, ex.s_x, ex.u_prev, ex.inner_y, ex.inner_z))
        check(all(torch.equal(a, b) for a, b in zip(got, ex)), f"round {t}: the fused round differs from "
              "c2dfb_round with the exchange's mixes: the exchange is at fault")
        dist = {n: float((a - b).abs().max()) for n, a, b in zip(
            names, got, _tensors((want.x, want.s_x, want.u_prev, want.inner_y, want.inner_z)))}
        print(f"[transport C4] round {t}: {seen.rows - rows_before} parted rows, every one a near-tie; the fused "
              f"round equals c2dfb_round with the exchange's mixes in value; its largest distance to run()'s round "
              f"by field: {dist}")
        state = want
    print(f"[transport C4] {T} rounds, {seen.compressions} compressions imposed: {seen.rows} parted rows, largest "
          f"relative k-th to (k+1)-th gap of a parted row {seen.rel_gap!r}, largest threshold gap "
          f"{seen.of_allowance!r} of its allowance")


# phase 11's depth: the dense exchange's host meter takes 50-75 s a round and
# the quant exchange's 37-49 s, so each exchange runs one round (every check
# is per round; launch counts scale with T)
TRANSPORT_T = 1
TRANSPORT_QUANT_T = 1


def phase_transport(dev, bundle, main_mets) -> dict:
    """The transports.

    (a) run(transport=DeviceTransport(fused=True, link="wan")) at TASK's
    width, kernel_topk, ring, K = 10, T = TRANSPORT_T: every residual packed on the
    card (B2, one launch a broadcast over every rank's blocks), the ring's
    two shifts moving the records, unpacked by every receiver and the sender
    (B3, 3 a broadcast): B1 4*K*T, B2 4*K*T and B3 3 * 4*K*T launches; no
    block held more than kpad survivors; each round's wire bytes the degree
    sum of its node bytes.  One more fused round body profiled.

    (b) The dense exchange at the same width, metered in the same chunked
    format (DeviceTransport(chunk=1 << 16)): its state and every metric bit
    for bit (a)'s, and its executed node bytes, which are
    wire.measure_tree_bytes_chunked of each dense slice, equal (a)'s from
    the packed records on every step and round.  The free runs' hypergradient
    norms part from run()'s (phase 4) at top-k near-ties, so the fused round is
    held to run()'s round by round on run()'s own states
    (`fused_on_run_states`).
    Then kernel_quant on a torch.Generator, T = TRANSPORT_QUANT_T, per-leaf
    format: B4 launches 4*K*T, every round meters the closed form.

    (a) and (b) are metered (obs): each round body's collective bytes a
    device equal the closed form (about 392 MB fused against 717 MB dense
    at this width), the fused below the dense, with their roofline terms.

    (c) The small config, card against host (phase_transport_small).

    (d), B2 and B3 timed at (a)'s stacked shapes, runs first in phase 3
    (transport_kernel_times); `device_ms` takes CUDA events instead of the
    profiler's sum wherever the profiler's records are incomplete.

    Returns the launch counts of B1, B2 and B3 in (a) and of B4 in (b)."""
    from repro_torch.core.c2dfb import C2DFBConfig
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.obs import MemorySink
    from repro_torch.obs.compute import device_collective_bytes
    from repro_torch.transport import DeviceTransport
    from repro_torch.transport import device as D

    K = CFG["K"]
    block, kpad = D.fused_pack_spec(C2DFBConfig(**CFG).make_compressor())
    most = []
    pack = D._pack_tree

    def counting(tree, block_, kpad_):
        vals, idx = pack(tree, block_, kpad_)
        most.append(max(int((i < block_).sum(-1).max()) for i in tree_leaves(idx)))
        return vals, idx

    D._pack_tree = counting
    fused_tr = DeviceTransport(fused=True, link="wan")
    try:
        fa = _transport_run(dev, bundle, fused_tr, CFG, TRANSPORT_T, obs=MemorySink())
    finally:
        D._pack_tree = pack
    _check_transport_run("[transport fused]", fa, CFG, TRANSPORT_T)
    n = 4 * K * TRANSPORT_T
    want = {"block_topk": n, "pack_sparse_blocks": n, "unpack_sparse_blocks": 3 * n}
    got = {k: fa["counts"][k] for k in want}
    check(got == want and fa["counts"]["quantize"] == 0, f"the fused run launched {fa['counts']}, want {want}")
    check(len(most) == n and max(most) <= kpad, f"a block held {max(most)} survivors, kpad {kpad}")
    print(f"[transport fused] most survivors in a block over the {len(most)} packs: {max(most)} (kpad {kpad}, "
          f"k {round(CFG['comp_ratio'] * block)})")
    profile_device_round(bundle, fa["state"], fused_tr)

    dense_tr = DeviceTransport(link="wan", chunk=1 << 16)
    fb = _transport_run(dev, bundle, dense_tr, CFG, TRANSPORT_T, obs=MemorySink())
    _check_transport_run("[transport dense]", fb, CFG, TRANSPORT_T)
    check(fb["counts"]["block_topk"] == n and fb["counts"]["pack_sparse_blocks"] == 0
          and fb["counts"]["unpack_sparse_blocks"] == 0, f"the dense run launched {fb['counts']}")
    from repro_torch.async_gossip.compiled import _tensors

    check(all(_same_bits(a, b) for a, b in zip(_tensors(fa["state"]), _tensors(fb["state"]))),
          "the dense exchange's state differs from the fused one's")
    for k, v in fa["mets"].items():
        if k not in ("wall_seconds", "meter_seconds", "sim_seconds"):
            check(_same_bits(v, fb["mets"][k]), f"metric {k} differs between the fused and the dense exchange")
    check(fa["reports"] == fb["reports"], "a node's executed bytes differ between the packed records and "
          "measure_tree_bytes_chunked of the dense slice")
    gap = np.abs(fa["mets"]["hypergrad_norm"] - main_mets["hypergrad_norm"][:TRANSPORT_T].double().cpu().numpy())
    print(f"[transport] fused and dense bit-identical (state, every metric; {sum(len(r) for r in fa['reports'])} "
          f"phases x {TASK['m']} node bytes equal); free runs' hypergrad_norm gap to run(): {gap.tolist()} "
          f"(run() {main_mets['hypergrad_norm'][:TRANSPORT_T].tolist()}), held round by round below")
    del fb
    smi, topo = nvidia_smi(), ring(TASK["m"])
    coll = {name: collectives_report(f"paper width {name}", tr.cost, device_collective_bytes(
        topo, C2DFBConfig(**CFG), bundle.x0, bundle.y0, fused=tr.fused), TASK["m"], smi)["collective_bytes"]
        for name, tr in (("fused", fused_tr), ("dense", dense_tr))}
    check(coll["fused"] < coll["dense"], f"the fused exchange moves {coll['fused']!r} collective bytes, the dense "
          f"{coll['dense']!r}")
    print(f"[collectives] paper width: the fused exchange moves {coll['fused'] / coll['dense']:.4f} of the dense "
          f"one's collective bytes")
    fused_on_run_states(dev, bundle, main_mets)

    fq = _transport_run(dev, bundle, DeviceTransport(link="wan"), CFG_QUANT, TRANSPORT_QUANT_T,
                        generator=torch.Generator(device=dev).manual_seed(0))
    _check_transport_run("[transport quant]", fq, CFG_QUANT, TRANSPORT_QUANT_T)
    check(fq["counts"]["quantize"] == 4 * CFG_QUANT["K"] * TRANSPORT_QUANT_T,
          f"the kernel_quant run launched {fq['counts']}")
    check(all(int(b) == quant_round_bytes()[1] for b in fq["mets"]["measured_bytes"]),
          f"kernel_quant measured_bytes {fq['mets']['measured_bytes'].tolist()}, want {quant_round_bytes()[1]}")
    counts = dict(block_topk=fa["counts"]["block_topk"], pack_sparse_blocks=fa["counts"]["pack_sparse_blocks"],
                  unpack_sparse_blocks=fa["counts"]["unpack_sparse_blocks"], quantize=fq["counts"]["quantize"])
    del fa, fq
    phase_transport_small(dev)
    return counts


def phase_transport_small(dev) -> None:
    """The device transport on a small input, card against host: ring (the
    neighbour-shift engine) and star (the all-gather engine), dense and
    fused, kernel_topk, with obs; then make_sharded_inner_loop on a
    quadratic.  States within TOL; wire bytes, measured bytes, every
    node's bytes, the rows' compute_flops / hbm_bytes and the round's
    collective bytes equal (those also to the closed form)."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.compression import KernelBlockTopK
    from repro_torch.core.distributed import make_sharded_inner_loop
    from repro_torch.core.inner_loop import inner_init
    from repro_torch.core.topology import make_topology
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.obs import MemorySink
    from repro_torch.obs.compute import device_collective_bytes
    from repro_torch.transport import DeviceTransport, mesh_for_nodes

    smi = nvidia_smi()
    cfg = C2DFBConfig(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    for name in ("ring", "star"):
        topo = make_topology(name, 4)
        for fused in (False, True):
            out = {}
            for d in ("cpu", dev):
                b = coefficient_tuning_task(m=4, n=200, p=64, c=4, seed=0, device=d)
                sink = MemorySink()
                tr = DeviceTransport(fused=fused, link="wan")
                st, mets = run(b.problem, topo, cfg, b.x0, b.y0, T=3, device=d, obs=sink, transport=tr)
                out[d] = (st, mets, [(r["compute_flops"], r["hbm_bytes"]) for r in sink.rows(kind="round")],
                          [r["node_bytes"] for r in sink.rows(kind="node")], tr.cost)
            (sc, mc, cc, nc, kc), (sg, mg, cg, ng, kg) = out["cpu"], out[dev]
            tag = f"small {name} {'fused' if fused else 'dense'}"
            for la, lb in zip(tree_leaves(sc.x) + tree_leaves(sc.inner_y.d) + tree_leaves(sc.inner_z.s_hat),
                              tree_leaves(sg.x) + tree_leaves(sg.inner_y.d) + tree_leaves(sg.inner_z.s_hat)):
                check(torch.allclose(lb.cpu(), la, **TOL), f"{tag}: the card's state differs from the host's")
            for k in ("wire_bytes", "measured_bytes", "sim_seconds"):
                check(np.array_equal(mc[k], mg[k]), f"{tag}: {k} differs between card and host")
            check(nc == ng and cc == cg, f"{tag}: node bytes or (compute_flops, hbm_bytes) differ: {cg[0]}, {cc[0]}")
            check(kg.collective_bytes == kc.collective_bytes, f"{tag}: collective_bytes card {kg.collective_bytes!r}, "
                  f"host {kc.collective_bytes!r}")
            print(f"[small transport] {tag}: card and host agree; wire_bytes {mg['wire_bytes'].tolist()}, "
                  f"measured_bytes {mg['measured_bytes'].tolist()}, (compute_flops, hbm_bytes) {cg[0]}, "
                  f"collective_bytes {kg.collective_bytes!r} (host {kc.collective_bytes!r})")
            collectives_report(tag, kg, device_collective_bytes(topo, cfg, sg.x, sg.inner_y.d, fused=fused), 4, smi)

    m, d_ = 4, 256
    rng = np.random.default_rng(0)
    A = torch.as_tensor(np.stack([np.eye(d_) * (1 + 0.2 * i) for i in range(m)]), dtype=torch.float32)
    bvec = torch.as_tensor(rng.normal(size=(m, d_)), dtype=torch.float32)
    d0 = torch.as_tensor(rng.normal(size=(m, d_)), dtype=torch.float32)
    res = {}
    for d in ("cpu", dev):
        data = {"A": A.to(d), "b": bvec.to(d)}
        loop = make_sharded_inner_loop(mesh_for_nodes(m, d), make_topology("ring", m),
                                       lambda w, dat: dat["A"] @ (w - dat["b"]),
                                       KernelBlockTopK(ratio=0.2, block=128), 0.4, 0.1, 10)
        st0 = inner_init(d0.to(d), lambda w: torch.einsum("mij,mj->mi", data["A"], w - data["b"]))
        res[d] = loop(st0, None, data)
    for a, b in zip(res["cpu"], res[dev]):
        check(torch.allclose(b.cpu(), a, **TOL), "make_sharded_inner_loop: the card differs from the host")
    print(f"[small transport] make_sharded_inner_loop (ring, kernel_topk, K = 10): card and host agree; "
          f"consensus {float(((res[dev].d - res[dev].d.mean(0)) ** 2).sum())!r}")


# ---------------------------------------------------------------- phase 12: the dense LM bilevel run

# phi3-mini-3.8b at its published width (arXiv:2404.14219), cut to LM_LAYERS
# of its 32 layers, the one cut; traffic: the reference launcher's c2dfb
# defaults (src/repro/launch/train.py:46-54, :141-145)
LM_ARCH = "phi3-mini-3.8b"
LM_LAYERS = 2
LM_M, LM_B, LM_S, LM_K, LM_T = 4, 4, 128, 5, 3
LM_LR = 3e-4
# lm-test (tests/test_lm_transport.py:132-137) for card against host
LM_TEST = dict(name="lm-test", arch_type="dense", pattern=("full",), mlp_type="swiglu", num_layers=1, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=128)
# a bf16 bound of the tests (tests/test_torch_lm_bilevel.py): a few bf16 steps
BF16_STEPS = 4 * 2.0 ** -8


def lm_problem(cfg, m: int, B: int, S: int, dev):
    """make_lm_bilevel on disjoint train and validation token streams
    (node_streams with seeds 0 and 1) and init_node_params from a seeded
    torch.Generator on ``dev``."""
    from repro_torch.core.lm_bilevel import init_node_params, make_lm_bilevel
    from repro_torch.data.synthetic import node_streams

    def data(seed):
        bs = [s.next_batch() for s in node_streams(m, cfg.vocab_size, S, B, seed=seed)]
        return {k: torch.from_numpy(np.stack([b[k] for b in bs])).to(dev) for k in ("tokens", "labels")}

    problem = make_lm_bilevel(cfg, data(0), data(1), m)
    x0, y0 = init_node_params(cfg, torch.Generator(device=dev).manual_seed(0), m)
    return problem, x0, y0


def lm_c2dfb(compressor: str, K: int = LM_K, ratio: float = 0.2, block: int = 1024):
    from repro_torch.core.c2dfb import C2DFBConfig

    return C2DFBConfig(lam=10.0, eta_out=LM_LR, gamma_out=0.5, eta_in=3 * LM_LR, gamma_in=0.5, K=K,
                       compressor=compressor, comp_ratio=ratio, comp_block=block)


@contextlib.contextmanager
def survivors_by_leaf(block: int):
    """Within the block, every KernelBlockTopK output's most nonzeros in a
    block, by leaf shape, kept on the card (read once, after)."""
    from repro_torch.core import compression as C

    most: dict = {}
    orig = C.block_topk_nodes

    def counting(x, ratio=0.2, block=block):
        out = orig(x, ratio=ratio, block=block)
        flat = out.reshape(out.shape[0], -1)
        nb = -(-flat.shape[1] // block)
        tiles = torch.nn.functional.pad(flat, (0, nb * block - flat.shape[1])).reshape(-1, block)
        cnt = torch.count_nonzero(tiles, dim=1).max()
        key = tuple(x.shape[1:])
        most[key] = cnt if key not in most else torch.maximum(most[key], cnt)
        return out

    C.block_topk_nodes = counting
    try:
        yield most
    finally:
        C.block_topk_nodes = orig


def _lm_run(problem, topo, cfg, x0, y0, T_, generator=None, transport=None, obs=None):
    from repro_torch.core.c2dfb import run
    from repro_torch.kernels import _build

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    dev = next(iter(problem.data_f.values())).device
    state, mets = run(problem, topo, cfg, x0, y0, T=T_, generator=generator, device=dev, transport=transport, obs=obs)
    torch.cuda.synchronize()
    return state, mets, _build.launch_counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _lm_checks(tag: str, state, mets, T_: int, y_shapes, x_dtypes=None) -> None:
    """Finite state and metrics, y's shapes, and every leaf at its dtype:
    bf16, or where ``x_dtypes`` is given, x and s_x leaf by leaf at those
    (the reference's: a Mamba block's f32 leaves in a bf16 model)."""
    from repro_torch.core.types import tree_leaves

    for is_x, tree in ((True, state.x), (True, state.s_x), (False, state.inner_y.d), (False, state.inner_z.d)):
        leaves = tree_leaves(tree)
        want = x_dtypes if x_dtypes is not None and is_x else [torch.bfloat16] * len(leaves)
        for leaf, dt in zip(leaves, want):
            check(leaf.dtype == dt, f"{tag}: a leaf left {dt} ({leaf.dtype})")
            check(bool(torch.isfinite(leaf).all()), f"{tag}: the state holds non-finite values")
    check([tuple(v.shape) for v in tree_leaves(state.inner_y.d)] == y_shapes, f"{tag}: y has the wrong shapes")
    for k, v in mets.items():
        v = np.asarray(v.float().cpu() if torch.is_tensor(v) else v, np.float64)
        check(v.shape[0] == T_ and bool(np.isfinite(v).all()), f"{tag}: metric {k} is {v}")


def phase_lm(dev) -> dict:
    """C2DFB on phi3-mini-3.8b (d_model 3,072, 32 heads of 96, d_ff 8,192,
    SwiGLU, vocab 32,064, untied head) at LM_LAYERS layers through run(),
    bf16 leaves, m = 4 on a ring, B = 4, S = 128, K = 5, lam = 10:

    (a) kernel_topk (0.2 of blocks of 1,024), T = 3 after a cold round:
        B1 bf16 launches 2 leaves x 4 K a round, none in f32; measured_bytes
        of every round; the most survivors in a block, by leaf; the first
        round's wall apart from the warm ones; a profiled warm round (busy
        share, time by kernel) and the peak memory;
    (b) kernel_quant on a torch.Generator, T = 2: B4 bf16 launches;
    (c) round_wire_bytes_measured on (a)'s final state: B2 launches, every
        payload the sparse codec's byte string;
    (d) the fused DeviceTransport at full width, T = 1 (its host meter
        takes tens of seconds a round): B2 and B3 launches, B3 by its
        bases' dtype, the survivors it dropped past kpad (counted here from
        the residuals), every record the plain pack's;
    (e) fused against dense bit for bit at the phi3-smoke width, m = 4, B2
        and B3 launched, B3 onto bf16 bases;
    (f) card against host on lm-test, round by round on the host's states
        with its selections, within the bf16 bound of the tests.

    Returns the bf16 launch counts of B1 (a) and B4 (b) and the fused run's
    B2 and B3 counts (at full width, else at the smoke width)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels.pack_residuals import padded_k

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_LAYERS)
    check(cfg.d_model == 3072 and cfg.vocab_size == 32064 and cfg.dtype == torch.bfloat16, f"{cfg} is not phi3-mini")
    topo = ring(LM_M)
    t0 = time.perf_counter()
    problem, x0, y0 = lm_problem(cfg, LM_M, LM_B, LM_S, dev)
    torch.cuda.synchronize()
    n_x = sum(v[0].numel() for v in tree_leaves(x0))
    n_y = sum(v[0].numel() for v in tree_leaves(y0))
    y_shapes = [tuple(v.shape) for v in tree_leaves(y0)]
    print(f"[lm] {cfg.name} at {cfg.num_layers} of 32 layers: d_model {cfg.d_model}, heads {cfg.num_heads}x"
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; x {n_x} and y {n_y} parameters a node, "
          f"m {LM_M}, B {LM_B}, S {LM_S}, K {LM_K}; built in {time.perf_counter() - t0:.3f} s, "
          f"{torch.cuda.memory_allocated()} bytes held; y leaves {y_shapes}")

    # (a) the synchronous run with kernel_topk
    tcfg = lm_c2dfb("kernel_topk")
    _, cmets, ccounts, cold, _ = _lm_run(problem, topo, tcfg, x0, y0, 1)
    print(f"[lm topk] cold round (traces the oracles): {cold!r} s, launches {ccounts}, measured_bytes "
          f"{int(cmets['measured_bytes'][0])}")
    with survivors_by_leaf(tcfg.comp_block) as most:
        state, mets, counts, wall, peak = _lm_run(problem, topo, tcfg, x0, y0, LM_T)
    most = {k: int(v) for k, v in most.items()}
    _lm_checks("[lm topk]", state, mets, LM_T, y_shapes)
    want = 2 * 4 * LM_K * LM_T
    print(f"[lm topk] {LM_T} warm rounds in {wall!r} s ({wall / LM_T!r} s a round), launches {counts}, peak device "
          f"memory {peak} bytes; measured_bytes {[int(b) for b in mets['measured_bytes']]}, hypergrad_norm "
          f"{mets['hypergrad_norm'].tolist()}")
    check(counts["block_topk_bf16"] == want and counts["block_topk"] == 0, f"B1 launched {counts}, want {want} bf16")
    check(int(cmets["measured_bytes"][0]) == int(mets["measured_bytes"][0]), "the cold round metered other bytes")
    kpad = padded_k(max(1, int(round(tcfg.comp_ratio * tcfg.comp_block))))
    print(f"[lm topk] the most survivors in a block, by leaf: {most} (kpad {kpad})")
    profile_lm_round(problem, topo, tcfg, state)

    # (c) the wire bytes of (a)'s final state, through the pack kernel
    lm_wire("[lm wire]", state, tcfg, topo, LM_M, len(y_shapes))
    times = lm_kernel_times(state.inner_y.d["lm_head"] - state.inner_y.d_hat["lm_head"], tcfg)
    del state, mets

    # (b) kernel_quant on a torch.Generator
    qcfg = lm_c2dfb("kernel_quant")
    qstate, qmets, qcounts, qwall, qpeak = _lm_run(problem, topo, qcfg, x0, y0, 2,
                                                   generator=torch.Generator(device=dev).manual_seed(0))
    _lm_checks("[lm quant]", qstate, qmets, 2, y_shapes)
    print(f"[lm quant] 2 rounds in {qwall!r} s, launches {qcounts}, peak {qpeak} bytes, measured_bytes "
          f"{[int(b) for b in qmets['measured_bytes']]}")
    check(qcounts["quantize_bf16"] == 2 * 4 * LM_K * 2 and qcounts["quantize"] == 0, f"B4 launched {qcounts}")
    del qstate, qmets
    out = dict(block_topk_bf16=counts["block_topk_bf16"], quantize_bf16=qcounts["quantize_bf16"], times=times)

    # (d) the fused exchange at full width; (e) at the smoke width
    out.update(lm_fused_full(problem, topo, tcfg, x0, y0, kpad))
    del problem, x0, y0
    smoke = lm_fused_smoke(dev)
    out.update({k: v for k, v in smoke.items() if k not in out})
    lm_card_against_host(dev)
    return out


def lm_wire(tag: str, state, cfg, topo, m: int, n_y: int) -> int:
    """round_wire_bytes_measured on ``state``: the pack kernel (B2) launches
    2 loops x 2 messages x m nodes x n_y leaves times, and every leaf payload
    of the block-sparse codec equals the sparse codec's byte string.
    Returns B2's launches."""
    from repro_torch.core.c2dfb import round_wire_bytes_measured
    from repro_torch.core.inner_loop import inner_transmit
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import _build
    from repro_torch.net.wire import SparseCodec, codec_for

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    wire = round_wire_bytes_measured(state, cfg, topo)
    wcounts = _build.launch_counts()
    print(f"{tag} round_wire_bytes_measured {wire} in {time.perf_counter() - t0:.3f} s, launches {wcounts}")
    check(wcounts["pack_sparse_blocks"] == 2 * 2 * m * n_y, f"B2 launched {wcounts}")
    codec = codec_for(cfg.make_compressor())
    t0 = time.perf_counter()
    inner = 0
    for inner_state in (state.inner_y, state.inner_z):
        for a, b in ((inner_state.d, inner_state.d_hat), (inner_state.s, inner_state.s_hat)):
            q = inner_transmit(cfg.make_compressor(), None, a, b)
            for i in range(m):
                for leaf in tree_leaves(q):
                    payload = codec.encode(leaf[i])
                    check(payload == SparseCodec().encode(leaf[i]), f"node {i}: a block-sparse payload differs")
                    inner += len(payload)
    check(inner * cfg.K == wire["inner_bytes"], "the payloads disagree with round_wire_bytes_measured")
    print(f"{tag} {2 * 2 * m * n_y} leaf payloads equal the sparse codec's in {time.perf_counter() - t0:.3f} s")
    return wcounts["pack_sparse_blocks"]


def lm_kernel_times(resid: torch.Tensor, cfg) -> dict:
    """B1 bf16, B4 bf16 and B2 on phase 12's own inputs: ``resid`` is the
    (m, 3,072, 32,064) bf16 lm_head residual of the run's final state, the
    leaf every top-k and quantizer launch of the run reads in place, and
    one node's slice of it, as the wire meter packs it (f32 tiles).  Each
    bit for bit against its plain version, timed beside its bound and, for
    B1, an exact top-k by torch.topk."""
    from repro_torch.kernels.pack_residuals import pack_sparse_blocks, pack_sparse_blocks_ref
    from repro_torch.kernels.quantize import quantize_leaf
    from repro_torch.kernels.ref import block_topk_ref
    from repro_torch.kernels.topk_compress import block_topk_leaf

    block = cfg.comp_block
    k = max(1, int(round(cfg.comp_ratio * block)))
    flat = resid.reshape(resid.shape[0], -1)
    m, d = flat.shape
    check(d % block == 0, f"the lm_head leaf ({d}) is not whole blocks")
    tiles = flat.reshape(-1, block)
    nbytes = flat.numel() * flat.element_size()
    out = {}
    got = block_topk_leaf(flat, k, block)
    want = block_topk_ref(tiles, k).reshape(m, d)
    torch.cuda.synchronize()
    check(same(got, want), "B1 bf16 on the lm_head leaf differs from its plain version")

    def lib():
        keep = torch.topk(tiles.abs(), k, dim=1).indices
        return torch.zeros_like(tiles).scatter_(1, keep, tiles.gather(1, keep))

    out["block_topk_bf16"] = dict(
        shape=[m, d], k=k, max_abs_err=float((got.float() - want.float()).abs().max()),
        **timed(lambda: block_topk_leaf(flat, k, block), iters=10),
        plain_ms=timed(lambda: block_topk_ref(tiles, k), iters=1, warmup=1)["ms"],
        bound_ms=bound_ms(2 * nbytes), bound_by="bytes", library_ms=timed(lib, iters=3, warmup=1)["ms"],
        library="exact top-k: torch.topk + scatter (not bisection)")
    del got, want
    u = torch.rand(tiles.shape, generator=torch.Generator(device=flat.device).manual_seed(5), device=flat.device,
                   dtype=flat.dtype)
    got = quantize_leaf(flat, u, 4, block)
    want = quant_leaf_want(flat, u, 4, block)
    torch.cuda.synchronize()
    check(same(got, want), "B4 bf16 on the lm_head leaf differs from its plain version")
    out["quantize_bf16"] = dict(
        shape=[m, d], bits=4, max_abs_err=float((got.float() - want.float()).abs().max()),
        **timed(lambda: quantize_leaf(flat, u, 4, block), iters=10),
        plain_ms=timed(lambda: quant_leaf_want(flat, u, 4, block), iters=1, warmup=1)["ms"],
        bound_ms=bound_ms(3 * nbytes), bound_by="bytes", library_ms=None)
    del got, want, u
    q = block_topk_leaf(flat[:1], k, block).reshape(-1, block).to(torch.float32)
    kk = max(1, int(torch.count_nonzero(q, dim=1).max()))
    vals, idx = pack_sparse_blocks(q, kk, block)
    rvals, ridx = pack_sparse_blocks_ref(q, kk, block)
    torch.cuda.synchronize()
    check(same(vals, rvals) and torch.equal(idx, ridx), "B2 on one node's lm_head leaf differs from its plain version")
    out["pack_sparse_blocks"] = dict(
        shape=list(q.shape), k=kk, max_abs_err=float((vals - rvals).abs().max()),
        **timed(lambda: pack_sparse_blocks(q, kk, block), iters=10),
        plain_ms=timed(lambda: pack_sparse_blocks_ref(q, kk, block), iters=1, warmup=1)["ms"],
        bound_ms=bound_ms(q.numel() * 4 + vals.numel() * 8), bound_by="bytes", library_ms=None)
    for name, entry in out.items():
        print(f"[lm kernels] {name} on phase 12's lm_head: {entry}")
    return out


def profile_lm_round(problem, topo, cfg, state) -> None:
    """One warm round from ``state``, then a profiled one: its wall, the
    device busy share, the B1 bf16 launches (2 leaves x 4 K) and the device
    time by kernel."""
    from repro_torch.core.c2dfb import c2dfb_round

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2dfb_round(state, None, problem, topo, cfg)
    torch.cuda.synchronize()
    print(f"[lm round] warm round wall {time.perf_counter() - t0!r} s")
    events, wall, ops = device_window(lambda: c2dfb_round(state, None, problem, topo, cfg), 1)
    busy = busy_us(events)
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    launches = sum(n for name, (_, n) in by_name.items() if "topk_kernel" in name)
    gemm = sum(us for name, (us, _) in by_name.items() if "gemm" in name.lower() or "xmma" in name.lower()
               or "cutlass" in name.lower())
    print(f"[lm round] profiled round: wall {wall!r} s, device busy {busy / 1e6!r} s ({busy / 1e6 / wall:.3f} of the "
          f"wall), {len(events)} device activities, {launches} topk_kernel launches, GEMM kernels {gemm / 1e3:.3f} ms, "
          f"{ops['aten::bmm']} bmm, {ops['aten::mm']} mm")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[lm round]   {us / 1e3:10.3f} ms  {n:5d}x  {name[:90]}")
    check(launches == 2 * 4 * cfg.K, f"a round launched B1 {launches} times, want {2 * 4 * cfg.K}")


@contextlib.contextmanager
def unpack_bases():
    """Within the block, every B3 leaf-entry launch of the fused exchange
    counted by the dtype of the leaf it writes (its base's)."""
    from repro_torch.transport import device as D

    bases: dict = {}
    leaf = D._unpack_leaf

    def counting(v, i, like, block, base=None):
        key = str((base if base is not None else like).dtype).removeprefix("torch.")
        bases[key] = bases.get(key, 0) + 1
        return leaf(v, i, like, block, base=base)

    D._unpack_leaf = counting
    try:
        yield bases
    finally:
        D._unpack_leaf = leaf


@contextlib.contextmanager
def dropped_survivors():
    """Within the block, every pack of the fused exchange watched from its
    input, the residuals: the survivors of each block past kpad (the ones
    the records leave out) summed, and each leaf's records held bit
    for bit against the plain pack of the same tiles.  The drop counts stay
    on the card until the block ends."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels.pack_residuals import pack_sparse_blocks_ref
    from repro_torch.transport import device as D

    seen = {"dropped": 0, "blocks": 0, "packs": 0, "equal": True}
    pack = D._pack_tree

    def watching(tree, block, kpad):
        vals_t, idx_t = pack(tree, block, kpad)
        for leaf, v, i in zip(tree_leaves(tree), tree_leaves(vals_t), tree_leaves(idx_t)):
            flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
            tiles = torch.nn.functional.pad(flat, (0, -flat.shape[1] % block)).reshape(-1, block)
            over = torch.clamp(torch.count_nonzero(tiles, dim=1) - kpad, min=0)
            seen["dropped"] = seen["dropped"] + over.sum()
            seen["blocks"] = seen["blocks"] + (over > 0).sum()
            pv, pi = pack_sparse_blocks_ref(tiles, kpad, block)
            same = _same_bits(v.reshape(pv.shape), pv) and torch.equal(i.reshape(pi.shape), pi)
            seen["equal"] = seen["equal"] and same
            seen["packs"] += 1
        return vals_t, idx_t

    D._pack_tree = watching
    try:
        yield seen
    finally:
        D._pack_tree = pack
        seen.update(dropped=int(seen["dropped"]), blocks=int(seen["blocks"]))


def lm_fused_full(problem, topo, cfg, x0, y0, kpad: int) -> dict:
    """run(transport=DeviceTransport(fused=True, verify=False)) at full
    width, T = 1: B1 bf16 2 x 4 K, B2 2 x 4 K (one a leaf a broadcast), B3
    3 x 2 x 4 K (the ring's two shifts and the sender's own reference),
    every B3 base bf16;
    each round's wire bytes the degree sum of its node bytes; the
    survivors the exchange dropped past kpad (as the reference's pack
    drops them), counted from the residuals, and every record the plain
    pack's.  The round is metered (obs): its collective bytes a device equal
    the closed form, printed with the dense exchange's closed form at this
    width (not run here) and both roofline terms."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.obs import MemorySink
    from repro_torch.obs.compute import device_collective_bytes
    from repro_torch.transport import DeviceTransport

    with unpack_bases() as bases, dropped_survivors() as seen:
        # unverified meters: the bytes are still the codec's encodings (the decode check alone doubled the round's
        # 130 s host meter); phi3-smoke's fused run below and phase 11 verify every message
        transport = DeviceTransport(fused=True, verify=False)
        reports = _recording_meter(transport)
        state, mets, counts, wall, peak = _lm_run(problem, topo, cfg, x0, y0, 1, transport=transport,
                                                  obs=MemorySink())
    n = 2 * 4 * cfg.K
    print(f"[lm fused] 1 round in {wall!r} s (body {float(mets['wall_seconds'][0])!r} s, meter "
          f"{float(mets['meter_seconds'][0])!r} s), launches {counts}, B3 by base dtype {bases}, peak {peak} bytes, "
          f"measured_bytes {int(mets['measured_bytes'][0])}, wire_bytes {int(mets['wire_bytes'][0])}")
    print(f"[lm fused] survivors dropped past kpad {kpad}: {seen['dropped']} in {seen['blocks']} blocks of "
          f"{seen['packs']} packed leaves; every record the plain pack's: {seen['equal']}")
    _lm_checks("[lm fused]", state, mets, 1, [tuple(v.shape) for v in tree_leaves(y0)])
    check(seen["equal"], "the fused exchange's records differ from the plain pack of the same tiles")
    check(seen["packs"] == n, f"the watch saw {seen['packs']} packed leaves, want {n}")
    check(counts["block_topk_bf16"] == n and counts["pack_sparse_blocks"] == n, f"the fused run launched {counts}")
    check(counts["unpack_sparse_blocks"] == 3 * n and bases == {"bfloat16": 3 * n}, f"B3: {counts}, bases {bases}")
    deg = [len(nb) for nb in topo.neighbors]
    check(sum(d * b for v in reports[0].values() for d, b in zip(deg, v)) == int(mets["wire_bytes"][0]),
          "the fused run's wire bytes are not the degree sum of its node bytes")
    smi = nvidia_smi()
    fused = collectives_report(f"{LM_ARCH} full width fused", transport.cost,
                               device_collective_bytes(topo, cfg, x0, y0, fused=True), topo.m, smi)
    # the dense exchange at this width: its closed form, beside the fused round's flops and hbm_bytes (the dense
    # round counts the same products: B2 and B3 multiply nothing)
    closed = device_collective_bytes(topo, cfg, x0, y0, fused=False)
    dense = collectives_report(f"{LM_ARCH} full width dense", dataclasses.replace(transport.cost, collective_bytes=closed),
                               closed, topo.m, smi, note=", the closed form alone: no dense round runs at this width")
    print(f"[collectives] {LM_ARCH} full width: the fused exchange moves "
          f"{fused['collective_bytes'] / dense['collective_bytes']:.4f} of the dense one's collective bytes")
    return dict(pack_sparse_blocks=counts["pack_sparse_blocks"], unpack_sparse_blocks=counts["unpack_sparse_blocks"],
                dropped_survivors=seen["dropped"])


def lm_fused_smoke(dev) -> dict:
    """phi3-smoke (SMOKE of the same file), m = 4, B = 4, S = 128, K = 5,
    kernel_topk, T = 2: the fused exchange bit for bit the dense one (every
    state tensor, every metric but the clocks, every node's bytes), B3's
    launches counted by their bases' dtype (all bf16).  Returns the fused
    run's B2 and B3 launches."""
    from repro_torch.async_gossip.compiled import _tensors
    from repro_torch.configs import get_config
    from repro_torch.core.topology import ring
    from repro_torch.obs import MemorySink
    from repro_torch.obs.compute import device_collective_bytes
    from repro_torch.transport import DeviceTransport

    cfg = get_config(LM_ARCH, smoke=True)
    problem, x0, y0 = lm_problem(cfg, LM_M, LM_B, LM_S, dev)
    ccfg = lm_c2dfb("kernel_topk")
    smi = nvidia_smi()
    runs = {}
    for fused in (True, False):
        tr = DeviceTransport(fused=fused, chunk=1 << 16)
        reports = _recording_meter(tr)
        with unpack_bases() as bases:
            state, mets, counts, wall, _ = _lm_run(problem, ring(LM_M), ccfg, x0, y0, 2, transport=tr,
                                                   obs=MemorySink())
        runs[fused] = (state, mets, reports, counts, bases)
        print(f"[lm smoke] {cfg.name} {'fused' if fused else 'dense'}: 2 rounds in {wall!r} s, launches {counts}, "
              f"B3 by base dtype {bases}")
        collectives_report(f"{cfg.name} {'fused' if fused else 'dense'}", tr.cost,
                           device_collective_bytes(ring(LM_M), ccfg, x0, y0, fused=fused), LM_M, smi)
    (sf, mf, rf, cf, bf), (sd, md, rd, _, bd) = runs[True], runs[False]
    n = 2 * 2 * 4 * ccfg.K
    check(cf["pack_sparse_blocks"] == n and cf["unpack_sparse_blocks"] == 3 * n and cf["block_topk_bf16"] == n
          and bf == {"bfloat16": 3 * n} and bd == {}, f"phi3-smoke: the fused run launched {cf}, B3 onto {bf}")
    check(all(_same_bits(a, b) for a, b in zip(_tensors(sf), _tensors(sd))), "phi3-smoke: fused state != dense")
    for k, v in mf.items():
        if k not in ("wall_seconds", "meter_seconds", "sim_seconds"):
            check(_same_bits(v, md[k]), f"phi3-smoke: metric {k} differs between fused and dense")
    check(rf == rd, "phi3-smoke: a node's executed bytes differ between fused and dense")
    print(f"[lm smoke] fused and dense bit-identical (state, metrics, {sum(len(r) for r in rf)} phases of node bytes)")
    return dict(pack_sparse_blocks=cf["pack_sparse_blocks"], unpack_sparse_blocks=cf["unpack_sparse_blocks"])


def lm_card_against_host(dev, cfg=None, steps: float = BF16_STEPS, rounds: int = 2) -> None:
    """lm-test (bf16; or ``cfg``), m = 8, B = 2, S = 32, K = 2,
    kernel_topk at 0.1 of blocks of 512, ``rounds`` rounds: the host steps its rounds
    and records its top-k selections; the card runs each round on the
    host's round-t state keeping them (a parted row must be a near-tie),
    and every field lies within the tests' bf16 bound of the host's:
    ``steps`` of a leaf's scale (of a tracker's, or of the gradients it
    sums if larger), times 1 + 2 lam for s_x and u."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import selection
    from repro_torch.core.c2dfb import c2dfb_round, init_state
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels import _build

    cfg = cfg or ModelConfig(**LM_TEST)
    ccfg = lm_c2dfb("kernel_topk", K=2, ratio=0.1, block=512)
    probs = {d: lm_problem(cfg, 8, 2, 32, d) for d in ("cpu", dev)}
    hp, hx, hy = probs["cpu"]
    for a, b in zip(tree_leaves(hx) + tree_leaves(hy), tree_leaves(probs[dev][1]) + tree_leaves(probs[dev][2])):
        check(a.dtype == b.dtype and a.shape == b.shape, "the card's and the host's parameters differ in shape")
    state = init_state(hp, ccfg, hx, hy)  # the host's parameters: the generators differ by device
    seen = selection.Partings()
    worst = 0.0
    _build.reset_launch_counts()

    def fields(st):
        return dict(x=st.x, s_x=st.s_x, u=st.u_prev, y=st.inner_y.d, y_s=st.inner_y.s, z=st.inner_z.d,
                    z_s=st.inner_z.s)

    for t in range(rounds):
        log = []
        with selection.recorded(log):
            want, _ = c2dfb_round(state, None, hp, ring(8), ccfg)
        on_card = _to(state, dev)
        with selection.imposed([(r.to(dev), k.to(dev)) for r, k in log], seen):
            got, _ = c2dfb_round(on_card, None, probs[dev][0], ring(8), ccfg)
        grads = dict(y_s=want.inner_y.g_prev, z_s=want.inner_z.g_prev)
        for name, g in fields(got).items():
            w = fields(want)[name]
            factor = 1 + 2 * ccfg.lam if name in ("s_x", "u") else 1
            for a, b, s in zip(tree_leaves(g), tree_leaves(w), tree_leaves(grads.get(name, w))):
                scale = max(float(b.float().abs().max()), float(s.float().abs().max()))
                err = float((a.cpu().float() - b.float()).abs().max())
                bound = factor * steps * scale
                worst = max(worst, err / bound if bound else 0.0)
                check(err <= bound, f"{cfg.name} round {t} {name}: card {err!r} off the host, bound {bound!r}")
        state = want
    counts = _build.launch_counts()
    check(counts["block_topk_bf16"] == 2 * 2 * 4 * rounds, f"{cfg.name} on the card launched {counts}")
    print(f"[lm host] {cfg.name} ({cfg.num_layers} layers) card against host, m 8, {rounds} rounds on the host's states: "
          f"within the bf16 bound of {steps / 2.0 ** -8:g} steps (largest {worst:.3f} of it), {seen.rows} parted "
          f"rows (near-ties), launches {counts}")


# mamba2-2.7b at its published width (arXiv:2405.21060), cut to SSM_LAYERS of
# its 64 layers, the one cut; the traffic of phase 12 (the reference
# launcher's c2dfb defaults)
SSM_ARCH = "mamba2-2.7b"
SSM_LAYERS = 2
# the tests' bf16 bound for a Mamba layer (tests/test_torch_lm_bilevel.py):
# 16 bf16 steps of a leaf's scale
A10B_STEPS = 4 * BF16_STEPS
# (d)'s depth: one round of each smoke on the host's state (each round is
# checked alike, so one keeps every bound)
A10B_ROUNDS = 1


def phase_archs(dev) -> dict:
    """Phase 13, the MoE, Mamba-2 and multimodal paths (A10b):

    (a) C2DFB on mamba2-2.7b (d_model 2,560, 80 SSM heads of 64, state 128,
        1 group, vocab 50,280, untied head) at SSM_LAYERS layers through
        run(), bf16 with the Mamba blocks' f32 a_log, d_skip and dt_bias,
        m = 4 on a ring, B = 4, S = 128, K = 5, lam = 10: kernel_topk, T = 3
        after a cold round (B1 bf16 2 leaves x 4 K a round; B1 f32 none:
        the f32 leaves lie in x, which C2DFB mixes uncompressed), every
        leaf at the reference's dtype, measured_bytes, the most survivors
        in a block by leaf, a profiled warm round, the peak memory;
        kernel_quant on a torch.Generator, T = 2 (B4 bf16); the wire bytes
        of (a)'s final state (B2, the sparse codec's byte strings);
    (b) one mixtral-8x7b block at full width, m = 1, B = 4, S = 128:
        lm_loss and its gradient through the recompute (time, peak memory,
        finite); the slots dropped at capacity 160 against the host's count
        on the same router logits; on 64 of its tokens at capacity factor 4,
        the dispatch against the direct top-2 mixture in f32;
    (c) seamless-m4t-medium at full depth (the encoder over S / 8 stub
        frames, lm_loss(memory=) and its gradient; the encoder's gradient
        nonzero; a change in the last frame moves the first decoder
        position); llama-3.2-vision-11b at one repeat (5 of 40 layers, 1,600
        patches: loss and gradient; the first block's output independent of
        the memory, bit for bit); one mamba2-2.7b layer at full width, B = 1,
        S = 512 (two chunks of 256), card against host;
    (d) jamba-smoke, mixtral-smoke and mamba2-smoke at their smoke depth,
        A10B_ROUNDS round(s) of each, m = 8, card against host on the host's states with
        its selections, within the tests' bf16 bound for these layers
        (A10B_STEPS of a leaf's scale).

    Returns (a)'s launch counts and timings."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.kernels.pack_residuals import padded_k

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_LAYERS)
    check(cfg.d_model == 2560 and cfg.ssm_heads == 80 and cfg.ssm_state == 128 and cfg.vocab_size == 50280
          and not cfg.tie_embeddings, f"{cfg} is not mamba2-2.7b")
    topo = ring(LM_M)
    t0 = time.perf_counter()
    problem, x0, y0 = lm_problem(cfg, LM_M, LM_B, LM_S, dev)
    torch.cuda.synchronize()
    n_x = sum(v[0].numel() for v in tree_leaves(x0))
    n_y = sum(v[0].numel() for v in tree_leaves(y0))
    y_shapes = [tuple(v.shape) for v in tree_leaves(y0)]
    x_dtypes = [v.dtype for v in tree_leaves(x0)]
    f32_leaves = sum(1 for d in x_dtypes if d == torch.float32)
    print(f"[ssm] {cfg.name} at {cfg.num_layers} of 64 layers: d_model {cfg.d_model}, {cfg.ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, groups {cfg.ssm_groups}, chunk {cfg.ssm_chunk}, vocab "
          f"{cfg.vocab_size}; x {n_x} ({f32_leaves} f32 leaves) and y {n_y} parameters a node, m {LM_M}, B {LM_B}, "
          f"S {LM_S}, K {LM_K}; built in {time.perf_counter() - t0:.3f} s; y leaves {y_shapes}")
    # a_log, d_skip and dt_bias of the pattern's one position, stacked over the layers
    check(f32_leaves == 3 * len(cfg.pattern), f"x holds {f32_leaves} f32 leaves, want a_log, d_skip and dt_bias")

    # (a) the synchronous run with kernel_topk
    tcfg = lm_c2dfb("kernel_topk")
    _, cmets, ccounts, cold, _ = _lm_run(problem, topo, tcfg, x0, y0, 1)
    print(f"[ssm topk] cold round (traces the oracles): {cold!r} s, launches {ccounts}, measured_bytes "
          f"{int(cmets['measured_bytes'][0])}")
    with survivors_by_leaf(tcfg.comp_block) as most:
        state, mets, counts, wall, peak = _lm_run(problem, topo, tcfg, x0, y0, LM_T)
    most = {k: int(v) for k, v in most.items()}
    _lm_checks("[ssm topk]", state, mets, LM_T, y_shapes, x_dtypes=x_dtypes)
    want = len(y_shapes) * 4 * LM_K * LM_T
    print(f"[ssm topk] {LM_T} warm rounds in {wall!r} s ({wall / LM_T!r} s a round), launches {counts}, peak "
          f"device memory {peak} bytes; measured_bytes {[int(b) for b in mets['measured_bytes']]}, hypergrad_norm "
          f"{mets['hypergrad_norm'].tolist()}")
    check(counts["block_topk_bf16"] == want and counts["block_topk"] == 0, f"B1 launched {counts}, want {want} bf16")
    check(int(cmets["measured_bytes"][0]) == int(mets["measured_bytes"][0]), "the cold round metered other bytes")
    kpad = padded_k(max(1, int(round(tcfg.comp_ratio * tcfg.comp_block))))
    print(f"[ssm topk] the most survivors in a block, by leaf: {most} (kpad {kpad})")
    profile_lm_round(problem, topo, tcfg, state)
    pack = lm_wire("[ssm wire]", state, tcfg, topo, LM_M, len(y_shapes))
    del state, mets

    # kernel_quant on a torch.Generator
    qcfg = lm_c2dfb("kernel_quant")
    qstate, qmets, qcounts, qwall, qpeak = _lm_run(problem, topo, qcfg, x0, y0, 2,
                                                   generator=torch.Generator(device=dev).manual_seed(0))
    _lm_checks("[ssm quant]", qstate, qmets, 2, y_shapes, x_dtypes=x_dtypes)
    print(f"[ssm quant] 2 rounds in {qwall!r} s, launches {qcounts}, peak {qpeak} bytes, measured_bytes "
          f"{[int(b) for b in qmets['measured_bytes']]}")
    check(qcounts["quantize_bf16"] == len(y_shapes) * 4 * LM_K * 2 and qcounts["quantize"] == 0,
          f"B4 launched {qcounts}")
    del qstate, qmets, problem, x0, y0
    out = dict(block_topk_bf16=counts["block_topk_bf16"], block_topk_f32=counts["block_topk"],
               quantize_bf16=qcounts["quantize_bf16"], pack_sparse_blocks=pack, peak_bytes=peak,
               warm_round_s=wall / LM_T)
    print(f"[ssm] (a) in {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    moe_block_full(dev)
    print(f"[archs] (b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    audio_full(dev)
    vlm_repeat(dev)
    mamba_layer_card_against_host(dev, cfg)
    print(f"[archs] (c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name in ("jamba-1.5-large-398b", "mixtral-8x7b", "mamba2-2.7b"):
        lm_card_against_host(dev, get_config(name, smoke=True), steps=A10B_STEPS, rounds=A10B_ROUNDS)
    print(f"[archs] (d) in {time.perf_counter() - t0:.1f} s; phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return out


def _grad_run(tag: str, cfg, params, loss_fn):
    """``loss_fn(params)``'s (m,) losses and their gradient (summed over the
    nodes) by torch.func.grad, timed and with the peak memory; every value
    finite."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = loss_fn(params)
    grads = torch.func.grad(lambda p: loss_fn(p).sum())(params)
    torch.cuda.synchronize()
    wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    from repro_torch.core.types import tree_leaves

    n = sum(v.numel() for v in tree_leaves(params))
    check(bool(torch.isfinite(loss).all()) and all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads)),
          f"{tag}: a non-finite loss or gradient")
    print(f"[{tag}] {cfg.name}: {n} parameters, loss {loss.tolist()}, loss and gradient in {wall!r} s, peak "
          f"{peak} bytes")
    return loss, grads


def _model(cfg, dev, seed: int = 0):
    from repro_torch.core.types import tree_map
    from repro_torch.models.transformer import init_lm_params

    return tree_map(lambda v: v.unsqueeze(0), init_lm_params(cfg, torch.Generator(device=dev).manual_seed(seed)))


def _tokens(cfg, dev, seed: int = 0):
    """Tokens and labels (1, LM_B, LM_S) from a seeded generator on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randint(0, cfg.vocab_size, (1, LM_B, LM_S), generator=g, device=dev),
            torch.randint(0, cfg.vocab_size, (1, LM_B, LM_S), generator=g, device=dev))


def moe_block_full(dev) -> None:
    """(b): one mixtral-8x7b block (8 experts of d_ff 14,336, top-2, window
    4,096) at m = 1, B = 4, S = 128."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_map
    from repro_torch.models import moe as M
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import _apply_block, embed_tokens, lm_loss

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=1)
    check(cfg.num_experts == 8 and cfg.d_ff == 14336 and cfg.window == 4096, f"{cfg} is not mixtral-8x7b")
    params = _model(cfg, dev)
    tokens, labels = _tokens(cfg, dev)
    _grad_run("moe", cfg, params, lambda p: lm_loss(p, cfg, tokens, labels))
    # the MoE's input: the block's attention half, then its norm
    blk = tree_map(lambda v: v[:, 0], params["blocks"][0])
    x = embed_tokens(params["embed"], tokens).to(cfg.dtype)
    pos = torch.arange(LM_S, dtype=torch.int32, device=dev).expand(LM_B, LM_S)
    no_moe = dict(blk)
    del no_moe["moe"], no_moe["norm2"]
    half, _ = _apply_block(no_moe, dataclasses.replace(cfg, d_ff=0), 0, x, pos)
    h = rms_norm(half, blk["norm2"], cfg.norm_eps)
    T_, E, k = LM_B * LM_S, cfg.num_experts, cfg.num_experts_per_tok
    C = max(8, int(T_ * k / E * 1.25))
    probs, idx, _ = M._route(blk["moe"], cfg, h.reshape(1, T_, -1))
    onehot = M._one_hot(idx.reshape(1, -1), E).to(torch.int64)
    pos_in = torch.sum((torch.cumsum(onehot, dim=1) - onehot) * onehot, dim=-1)
    dropped = int((pos_in >= C).sum())
    # the host, from the same router probabilities: a stable descending sort,
    # then each slot's token-major position in its expert
    hp = probs[0].cpu().numpy()
    order = np.argsort(-hp, axis=-1, kind="stable")[:, :k].reshape(-1)
    seen_e = np.zeros(E, np.int64)
    host = 0
    for e in order:
        host += int(seen_e[e] >= C)
        seen_e[e] += 1
    check(np.array_equal(order, idx.reshape(-1).cpu().numpy()), "the card's top-2 experts differ from the host's")
    check(dropped == host, f"the card drops {dropped} slots at capacity {C}, the host {host}")
    print(f"[moe] capacity {C}: {dropped} of {T_ * k} slots dropped (host {host}); experts' loads "
          f"{seen_e.tolist()}")
    # 64 tokens at capacity factor 4 in f32: the dispatch against the direct top-2 mixture
    p32 = tree_map(lambda v: v.to(torch.float32), blk["moe"])
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    xt = h.reshape(1, 1, -1, h.shape[-1])[:, :, :64].to(torch.float32)  # (m, B, S, D) = (1, 1, 64, 4,096)
    got, _ = M.moe_apply(p32, c32, xt, capacity_factor=4.0)
    _, idx64, gates = M._route(p32, c32, xt.reshape(1, 64, -1))
    want = torch.zeros_like(xt.reshape(64, -1))
    for t in range(64):
        for j in range(k):
            e = int(idx64[0, t, j])
            a = xt[0, 0, t] @ p32["wg"][0, e]
            hid = a * torch.sigmoid(a) * (xt[0, 0, t] @ p32["wi"][0, e])
            want[t] += gates[0, t, j] * (hid @ p32["wo"][0, e])
    err = float((got.reshape(64, -1) - want).abs().max())
    check(torch.allclose(got.reshape(64, -1), want, atol=2e-4, rtol=1e-3),
          f"the dispatch at capacity factor 4 is {err} off the direct top-2 mixture")
    print(f"[moe] 64 tokens at capacity factor 4 (f32): the dispatch within {err:.3g} of the direct top-2 mixture")
    del params, p32


def audio_full(dev) -> None:
    """(c): seamless-m4t-medium at full depth, m = 1, B = 4, S = 128, 16
    stub frames."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.models.transformer import encoder_forward, forward_hidden, lm_loss

    cfg = get_config("seamless-m4t-medium")
    check(cfg.num_layers == 12 and cfg.enc_layers == 12 and cfg.vocab_size == 256206, f"{cfg} is not seamless")
    params = _model(cfg, dev)
    tokens, labels = _tokens(cfg, dev)
    frames = torch.randn((1, LM_B, LM_S // cfg.enc_seq_ratio, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(3), device=dev).to(cfg.dtype)
    _, grads = _grad_run("audio", cfg, params,
                         lambda p: lm_loss(p, cfg, tokens, labels, memory=encoder_forward(p, cfg, frames)))
    enc = [float(g.float().abs().max()) for g in tree_leaves(grads["encoder"])]
    check(min(enc) > 0, f"an encoder leaf's gradient is zero: {enc}")
    moved = frames.clone()
    moved[0, :, -1] += 10.0
    h1, _ = forward_hidden(params, cfg, tokens, memory=encoder_forward(params, cfg, frames))
    h2, _ = forward_hidden(params, cfg, tokens, memory=encoder_forward(params, cfg, moved))
    d = float((h1[:, :, 0].float() - h2[:, :, 0].float()).abs().max())
    check(d > 0, "a change in the last frame left the first decoder position unchanged")
    print(f"[audio] every encoder leaf's gradient nonzero (smallest max {min(enc):.3g}); the last frame moves the "
          f"first decoder position by {d:.3g}")
    del params, grads


def vlm_repeat(dev) -> None:
    """(c): llama-3.2-vision-11b at one repeat of its (full x 4, cross)
    pattern, m = 1, B = 4, S = 128, 1,600 patches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_map
    from repro_torch.models.transformer import _apply_block, embed_tokens, lm_loss

    cfg = get_config("llama-3.2-vision-11b")
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.pattern))
    check(cfg.num_patches == 1600 and cfg.pattern[-1] == "cross", f"{cfg} is not llama-3.2-vision")
    params = _model(cfg, dev)
    tokens, labels = _tokens(cfg, dev)
    patches = torch.randn((1, LM_B, cfg.num_patches, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(4),
                          device=dev).to(cfg.dtype)
    _grad_run("vlm", cfg, params, lambda p: lm_loss(p, cfg, tokens, labels, memory=patches))
    x = embed_tokens(params["embed"], tokens).to(cfg.dtype)
    pos = torch.arange(LM_S, dtype=torch.int32, device=dev).expand(LM_B, LM_S)
    blk0 = tree_map(lambda v: v[:, 0], params["blocks"][0])
    o1, _ = _apply_block(blk0, cfg, 0, x, pos, patches)
    o2, _ = _apply_block(blk0, cfg, 0, x, pos, patches + 5.0)
    check(_same_bits(o1, o2), "the first (text) block's output depends on the image memory")
    print("[vlm] the first block's output is independent of the memory, bit for bit")
    del params


def mamba_layer_card_against_host(dev, cfg) -> None:
    """(c): one Mamba-2 layer of ``cfg`` at full width, B = 1, S = 512 (two
    chunks of 256, so the carried state crosses a chunk), its parameters and
    input drawn on the host; card against host within the tests' bf16 bound
    (A10B_STEPS of the output's scale)."""
    from repro_torch.core.types import tree_map
    from repro_torch.models.ssm import mamba_apply, mamba_init

    check(cfg.ssm_chunk == 256, f"chunk {cfg.ssm_chunk}")
    g = torch.Generator().manual_seed(5)
    p = tree_map(lambda v: v.unsqueeze(0), mamba_init(g, cfg)[0])
    x = torch.randn((1, 1, 512, cfg.d_model), generator=g).to(cfg.dtype)
    t0 = time.perf_counter()
    want, wstate = mamba_apply(p, cfg, x)
    host_s = time.perf_counter() - t0
    got, gstate = mamba_apply(tree_map(lambda v: v.to(dev), p), cfg, x.to(dev))
    torch.cuda.synchronize()
    for name, a, b in (("out", got, want), ("state", gstate, wstate)):
        err = float((a.cpu().float() - b.float()).abs().max())
        bound = A10B_STEPS * float(b.float().abs().max())
        check(err <= bound, f"a full-width Mamba layer's {name}: card {err!r} off the host, bound {bound!r}")
        print(f"[ssm layer] {name} {tuple(a.shape)} {a.dtype}: card within {err:.4g} of the host (bound {bound:.4g}); "
              f"host {host_s:.2f} s")


# ---------------------------------------------------------------------------
# phase 14: the step factories, optimizers, checkpoints and the two CLIs (A10c)
# ---------------------------------------------------------------------------

# gemma2-27b served at its published width and full depth (46 layers: 23
# repeats of (swa, full), window 4,096): the prompt is exactly the window long,
# below which the reference's prefill keeps only min(window, S) ring slots and
# the first decode step overwrites position 0 while the window still holds it
GEMMA_SERVE = ["--arch", "gemma2-27b", "--batch", "2", "--prompt-len", "4096", "--gen", "16"]
PHI3_SERVE = ["--arch", "phi3-mini-3.8b", "--batch", "4", "--prompt-len", "64", "--gen", "32"]
PHI3_TRAIN = ["--arch", "phi3-mini-3.8b", "--algo", "adamw", "--steps", "3", "--batch", "4", "--seq", "128"]
CKPT_TRAIN = ["--arch", "phi3-mini-3.8b", "--smoke", "--algo", "adamw", "--steps", "3"]
C2DFB_CLI = ["--arch", "qwen2-7b", "--smoke", "--algo", "c2dfb", "--compressor", "kernel_topk", "--steps", "2",
             "--batch", "2", "--seq", "64", "--nodes", "3", "--inner-k", "3", "--lr", "0.02"]
# the stated CPU bounds of tests/test_torch_decode.py (atol of logits and
# caches; Mamba blocks 1e-4) and of tests/test_torch_steps.py (the gradient)
DECODE_ATOL = {"dense": 2e-5, "mamba": 1e-4}
GRAD_ATOL = {"dense": 2e-6, "mamba": 1e-5}


@contextlib.contextmanager
def patched(module, **attrs):
    """Set module attributes for the duration (the CLIs' factories, to
    capture what main() builds); restored after."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _cli_run(tag: str, main, argv: list, smi: str):
    """``main(argv)`` in process after freeing the card: its result, wall
    seconds and peak device memory, printed with the card."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    print(f"[{tag}] {' '.join(argv)}: {wall:.3f} s wall, peak device memory {peak} bytes ({held} held before); {smi}")
    return out, wall, peak


def _named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in the trees' flattening order (sorted dict keys,
    lists in order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _capture_params(module, box: dict):
    """A stand-in for ``module.init_lm_params`` that keeps what it returns."""
    init = module.init_lm_params

    def capture(cfg, generator, device=None):
        box["params"], box["cfg"] = init(cfg, generator, device), cfg
        return box["params"]

    return capture


def serve_consistency(tag: str, argv: list, smi: str, checks: int, steps: float = BF16_STEPS, f32: bool = False,
                      dev: str = "cuda") -> dict:
    """The serve CLI's main(argv) on the card, its prefill and decode logits
    recorded (each decode step's end by a CUDA event); then the logits of
    the prefill and of each of the first ``checks`` decode steps against the
    last-position logits of a forward over the prompt plus the tokens
    generated so far: one forward over the prompt and every generated token,
    padded to a multiple of the attention's query chunk (causal masks: the
    padding reaches no earlier position), within ``steps`` bf16 steps of the
    logits' scale.  With ``f32``, the same in f32 on the parameters cast up
    (the port's prefill and decode steps fed the CLI's tokens), within the
    golden rtol 1e-4 of the logits' scale: a check of the decode path (cache
    slots, positions) free of bf16's rounding.  Then one more decode step
    under the profiler: its wall, the device's busy share and the host
    operators it dispatched."""
    from repro_torch.core.types import tree_leaves, tree_map
    from repro_torch.launch import serve as SV
    from repro_torch.models import steps as ST
    from repro_torch.models import transformer as PT

    box, logits, ends = {}, [], []
    prefill0, serve0 = SV.make_prefill_step, SV.make_serve_step

    def prefill_rec(cfg, max_len=None):
        step = prefill0(cfg, max_len=max_len)

        def rec(params, batch):
            box["prompts"] = batch["tokens"]
            out = step(params, batch)
            logits.append(out[0])
            return out
        return rec

    def serve_rec(cfg):
        step = serve0(cfg)

        def rec(*a):
            out = step(*a)
            logits.append(out[0])
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
            box["last"] = (step, a[:3] + (out[1],) + a[4:])
            return out
        return rec

    with patched(SV, init_lm_params=_capture_params(SV, box), make_prefill_step=prefill_rec,
                 make_serve_step=serve_rec):
        tokens, wall, peak = _cli_run(tag, SV.main, argv + ["--device", dev], smi)
    params, cfg, prompts = box.pop("params"), box.pop("cfg"), box.pop("prompts")
    n = sum(v.numel() for v in tree_leaves(params))
    S = prompts.shape[1]
    step_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    seq = torch.cat([prompts, tokens], dim=1)
    chunk = min(1024, seq.shape[1])
    seq = torch.nn.functional.pad(seq, (0, -seq.shape[1] % chunk))

    def forward_logits(p, c):
        with torch.no_grad():
            p1 = PT.one_node(p)
            hidden, _ = PT.forward_hidden(p1, c, seq.unsqueeze(0))
            return PT.head_logits(p1, c, hidden[:, :, S - 1:S + checks].transpose(1, 2))[0]  # (checks + 1, B, V)

    def compare(got: list, want, bound_of, what: str) -> float:
        worst = 0.0
        for i in range(checks + 1):
            bound = bound_of(want[i])
            err = float((got[i].float() - want[i].float()).abs().max())
            worst = max(worst, err / bound)
            check(err <= bound, f"[{tag}] {what} {'prefill' if i == 0 else f'decode step {i - 1}'}: {err!r} off a "
                                f"forward over the prompt and the tokens so far, bound {bound!r}")
        return worst

    worst = compare(logits, forward_logits(params, cfg), lambda w: steps * float(w.abs().max()), "bf16")
    print(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, {n} parameters; the prefill and the first {checks} decode "
          f"steps within {steps / 2.0 ** -8:g} bf16 steps of a forward over the prompt and the tokens so far "
          f"(largest {worst:.3f} of it); tokens {tuple(tokens.shape)}; decode steps after the first "
          f"{min(step_ms):.2f}-{max(step_ms):.2f} ms (median {float(np.median(step_ms)):.2f}) by CUDA events")
    out = dict(wall_s=wall, peak_bytes=peak, parameters=n, step_ms=float(np.median(step_ms)))
    step, args = box.pop("last")
    events, pwall, ops = device_window(lambda: step(*args), 1)
    busy, nops = busy_us(events), sum(ops.values())
    print(f"[{tag}] one more decode step profiled: {pwall * 1e3:.2f} ms wall, device busy {busy / 1e3:.2f} ms "
          f"({busy / 1e6 / pwall:.3f}), {len(events)} device activities, {nops} host operators "
          f"({pwall * 1e6 / max(nops, 1):.1f} us of wall each)")
    out.update(profiled_ms=pwall * 1e3, busy_share=busy / 1e6 / pwall, host_ops=nops)
    del args
    if f32:
        c32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = tree_map(lambda v: v.float(), params)
        del params
        got = []
        lg, caches = ST.make_prefill_step(c32, max_len=seq.shape[1])(p32, {"tokens": prompts})
        got.append(lg)
        serve = ST.make_serve_step(c32)
        for i in range(checks):
            lg, caches = serve(p32, tokens[:, i], S + i, caches)
            got.append(lg)
        worst = compare(got, forward_logits(p32, c32), lambda w: TOL["rtol"] * float(w.abs().max()), "f32")
        print(f"[{tag}] in f32 (the parameters cast up): the prefill and {checks} decode steps within the golden "
              f"rtol 1e-4 of the logits' scale of a forward over the prompt and the tokens so far (largest "
              f"{worst:.3f} of it)")
        del p32, caches
    return out


def train_full(smi: str, dev: str = "cuda") -> dict:
    """(b): phi3-mini-3.8b at its published width and full depth, AdamW, 3
    steps, B = 4, S = 128 through the train CLI: finite losses, every leaf
    moved, the peak beside the reckoning, and each step's loss and
    gradient, clip and update by CUDA events."""
    from repro_torch.core.types import tree_leaves
    from repro_torch.launch import train as TR
    from repro_torch.models import steps as ST

    box, marks = {}, []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    make0, clip0, opt0 = TR.make_train_step, ST.clip_by_global_norm, ST.make_optimizer
    seen = {}

    def fingerprint(v):  # a sum of the leaf's bit patterns: any change of an entry changes it (almost surely)
        return torch.sum(v.view(torch.int16 if v.dtype == torch.bfloat16 else torch.int32), dtype=torch.int64)

    def make(cfg, name, lr):
        step, opt = make0(cfg, name, lr=lr)

        def timed(params, opt_state, batch):
            if not seen:
                seen["before"] = [fingerprint(v) for v in tree_leaves(params)]
            mark()
            return step(params, opt_state, batch)
        return timed, opt

    def clip(g, c):
        mark()
        out = clip0(g, c)
        mark()
        return out

    def optimizer(name, moment_dtype):
        o = opt0(name, moment_dtype=moment_dtype)

        def update(*a, **k):
            out = o.update(*a, **k)
            mark()
            return out
        return dataclasses.replace(o, update=update)

    with patched(TR, make_train_step=make, init_lm_params=_capture_params(TR, box)), \
            patched(ST, clip_by_global_norm=clip, make_optimizer=optimizer):
        history, wall, peak = _cli_run("train full", TR.main, PHI3_TRAIN + ["--device", dev], smi)
    params, cfg = box.pop("params"), box.pop("cfg")
    check(cfg.name == "phi3-mini-3.8b" and cfg.num_layers == 32 and cfg.d_model == 3072,
          f"{cfg} is not phi3-mini at full depth")
    check(len(history) == 3 and all(np.isfinite(history)), f"the losses are {history}")
    # every weight moved; a norm leaf (all ones) cannot in bf16 at lr 3e-4, in either package: 1 - lr (1 + wd)
    # lies within half a bf16 step below 1.0 (2^-10), so the cast rounds it back to 1
    named = _named_leaves(params)
    moved = {k: bool(fingerprint(v) != b) for (k, v), b in zip(named, seen["before"])}
    weights = [k for k, _ in named if "norm" not in k.rsplit("/", 1)[-1]]
    check(all(moved[k] for k in weights), f"weights that did not move: {[k for k in weights if not moved[k]]}")
    norms = [k for k, v in named if k not in weights]
    check(all(bool(torch.all(v == 1)) for k, v in named if k in norms), "a norm leaf moved off 1.0 in bf16 at lr 3e-4")
    n = sum(v.numel() for v in tree_leaves(params))
    torch.cuda.synchronize()
    parts = []
    for s in range(3):
        e = marks[4 * s:4 * s + 4]
        parts.append([e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]), e[2].elapsed_time(e[3])])
    reckoned = n * (2 + 2 + 4 + 4)  # bf16 parameters and gradients, f32 m and v
    print(f"[train full] {cfg.name}: {n} parameters; losses {history}; every one of the {len(weights)} weight leaves "
          f"moved, the {len(norms)} norm leaves ({norms}) stay at 1.0 in bf16; peak {peak} bytes against "
          f"{reckoned} bytes of parameters, gradients and moments (the reckoning: 55-62 GB with temporaries)")
    for s, (lg, cl, up) in enumerate(parts):
        print(f"[train full] step {s}: loss and gradient {lg:.3f} ms, clip {cl:.3f} ms, update {up:.3f} ms "
              f"(CUDA events)")
    del params
    return dict(wall_s=wall, peak_bytes=peak, parameters=n, losses=history, parts_ms=parts)


def checkpoint_on_card(smi: str, dev: str = "cuda") -> dict:
    """(c): phi3-smoke, AdamW, 3 steps with --ckpt-dir (a temporary
    directory, removed after) through the train CLI; the file loaded back
    with load_pytree on the card equals the trained parameters bit for bit;
    then zlib's rate on one 100 MB bf16 leaf."""
    import tempfile

    from repro_torch.checkpoint import io as CIO
    from repro_torch.core.types import tree_leaves
    from repro_torch.launch import train as TR

    box = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        with patched(TR, init_lm_params=_capture_params(TR, box)):
            _cli_run("ckpt", TR.main, CKPT_TRAIN + ["--ckpt-dir", ckpt_dir, "--device", dev], smi)
        params = box.pop("params")  # the train step updates in place: these are the trained parameters
        path = CIO.latest_checkpoint(ckpt_dir)
        check(path is not None and path.endswith("ckpt_00000003.msgpack.zst"), f"no checkpoint in {ckpt_dir}: {path}")
        with open(path, "rb") as f:
            head = f.read(4)
        codec = "zstd" if head == CIO._ZSTD_MAGIC else "zlib"
        size = Path(path).stat().st_size
        restored = CIO.load_pytree(path, params)
    for a, b in zip(tree_leaves(restored), tree_leaves(params)):
        check(a.device == b.device and _same_bits(a, b), "a restored leaf differs from the trained one")
    print(f"[ckpt] {Path(path).name} ({codec}, {size} bytes): {len(tree_leaves(params))} leaves restored on the card "
          f"bit for bit")
    leaf = torch.randn((50_000_000,), generator=torch.Generator(device=dev).manual_seed(9), device=dev).to(
        torch.bfloat16)
    t0 = time.perf_counter()
    raw = CIO.packb({b"leaves": [CIO._pack_leaf(leaf)], b"treedef": b"PyTreeDef({'w': *})"})
    t1 = time.perf_counter()
    comp = CIO._compress(raw)
    t2 = time.perf_counter()
    back = CIO.unpackb(CIO._decompress(comp))
    t3 = time.perf_counter()
    check(_same_bits(CIO._unpack_leaf(back[b"leaves"][0]).to(dev), leaf), "the 100 MB leaf did not round-trip")
    rate = len(raw) / (t2 - t1) / 1e6
    print(f"[ckpt] one {len(raw)}-byte bf16 leaf: pack (copy to host, msgpack) {t1 - t0:.3f} s, {codec} "
          f"{t2 - t1:.3f} s ({rate:.1f} MB/s, {len(comp) / len(raw):.3f} of the size), decompress and unpack "
          f"{t3 - t2:.3f} s")
    return dict(codec=codec, compress_mb_s=rate)


def c2dfb_cli(smi: str, dev: str = "cuda") -> int:
    """(d): the c2dfb CLI with kernel_topk on the card and on the host: B1
    bf16 launches 2 head leaves x 4 K x steps, none in f32; the printed wire
    bytes the host's; every val-loss finite."""
    import io

    from repro_torch.kernels import _build
    from repro_torch.launch import train as TR

    lines = []
    for where in (dev, "cpu"):
        buf = io.StringIO()
        _build.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            _cli_run(f"c2dfb cli {where}", TR.main, C2DFB_CLI + ["--device", where], smi)
        counts = _build.launch_counts()
        out = buf.getvalue()
        print(out, end="")
        lines.append(out)
        vals = [float(v) for v in re.findall(r"val-loss (\S+)", out)]
        check(len(vals) == 2 and all(np.isfinite(vals)), f"[c2dfb cli {where}] val-losses {vals}")
        if len(lines) == 1:
            launches = counts["block_topk_bf16"]
            want = 2 * 4 * 3 * 2
            check(launches == want and counts["block_topk"] == 0, f"the c2dfb CLI launched {counts}, want {want} bf16")
    wire = [re.search(r"wire bytes/round: .*", out).group(0) for out in lines]
    check(wire[0] == wire[1], f"the card's {wire[0]!r} is not the host's {wire[1]!r}")
    print(f"[c2dfb cli] B1 bf16 {launches} launches (2 head leaves x 4 K x 2 rounds), f32 0; {wire[0]} on both")
    return launches


def _near_tie_steps(host_logits: list, host_tokens: list, card_tokens: list, gap: float) -> int:
    """Steps whose greedy tokens agree before the first near-tie (the host's
    top two logits within ``gap``); a parting away from a near-tie fails."""
    for i, (lg, ht, ct) in enumerate(zip(host_logits, host_tokens, card_tokens)):
        top2 = torch.topk(lg, 2, dim=-1).values
        if bool(((top2[:, 0] - top2[:, 1]) <= gap).any()):
            return i
        check(torch.equal(ht, ct.cpu()), f"greedy tokens part at step {i}, away from a near-tie")
    return len(host_tokens)


def steps_card_against_host(name: str, dtype, dev: str = "cuda") -> None:
    """(e): a smoke config at ``dtype``, B = 2, S = 64, parameters drawn on
    the host: one SGD-M train step (the loss and the parameters; f32: the
    clipped gradient within the tests' gradient bound and the parameters
    within the golden tolerance plus lr times it), the prefill (logits
    and every cache leaf) and 8 decode steps fed the host's greedy token
    (logits; the final caches; greedy tokens up to the first near-tie),
    within the CPU tests' bounds in f32 and 4 bf16 steps of a leaf's scale
    in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves, tree_map
    from repro_torch.models import steps as ST
    from repro_torch.models import transformer as PT

    cfg = dataclasses.replace(get_config(name, smoke=True), dtype=dtype)
    family = "mamba" if "mamba" in cfg.pattern else "dense"
    host = PT.init_lm_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    f32 = dtype == torch.float32
    worst = 0.0

    def close(a, b, atol, what):
        nonlocal worst
        a, b = a.cpu().float(), b.float()
        if not f32:
            atol, rtol = BF16_STEPS * float(b.abs().max()), 0.0
        else:
            rtol = TOL["rtol"]
        err = (a - b).abs()
        lim = atol + rtol * b.abs()
        worst = max(worst, float((err / lim.clamp_min(1e-30)).max()))
        check(bool((err <= lim).all()), f"[steps host] {name} {what}: card {float(err.max())!r} off the host")

    # one SGD-M step
    lr = 1e-2
    results = {}
    for where in ("host", "card"):
        d = "cpu" if where == "host" else dev
        params = tree_map(lambda v: v.to(d, copy=True), host)
        step, opt = ST.make_train_step(cfg, "sgd", lr=lr)
        results[where] = step(params, opt.init(params), {k: v.to(d) for k, v in batch.items()})
    (hp, hs, hm), (cp, cs, cm) = results["host"], results["card"]
    close(cm["loss"], hm["loss"], TOL["atol"], "loss")
    if f32:  # the first momentum is the clipped gradient; in bf16 a leaf's sum may cancel far below its terms' scale
        for a, b in zip(tree_leaves(cs.m), tree_leaves(hs.m)):
            close(a, b, GRAD_ATOL[family], "gradient")
    for a, b in zip(tree_leaves(cp), tree_leaves(hp)):
        close(a, b, TOL["atol"] + lr * GRAD_ATOL[family], "parameters after a step")
    # prefill and 8 greedy decode steps, fed the host's token
    atol = DECODE_ATOL[family]

    def caches_close(got, want, what):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if b.dtype == torch.int32:
                check(torch.equal(a.cpu(), b), f"[steps host] {name} {what}: slot_pos differs")
            else:
                close(a, b, atol, what)

    out = {}
    for where in ("host", "card"):
        d = "cpu" if where == "host" else dev
        params = tree_map(lambda v: v.to(d), host)
        logits, caches = ST.make_prefill_step(cfg, max_len=72)(params, {"tokens": tokens.to(d)})
        out[where] = dict(dev=d, params=params, steps=[logits], toks=[], prefill=caches, caches=caches)
    caches_close(out["card"]["prefill"], out["host"]["prefill"], "prefill caches")
    serve = ST.make_serve_step(cfg)
    for i in range(8):
        tok = torch.argmax(out["host"]["steps"][-1], -1).to(torch.int32)
        for o in out.values():
            o["toks"].append(torch.argmax(o["steps"][-1], -1).to(torch.int32))
            logits, o["caches"] = serve(o["params"], tok.to(o["dev"]), 64 + i, o["caches"])
            o["steps"].append(logits)
    gap = 0.0
    for i, (a, b) in enumerate(zip(out["card"]["steps"], out["host"]["steps"])):
        close(a, b, atol, f"logits at step {i}")
        gap = max(gap, float((a.cpu() - b).abs().max()))
    caches_close(out["card"]["caches"], out["host"]["caches"], "caches after 8 steps")
    agree = _near_tie_steps(out["host"]["steps"], out["host"]["toks"], out["card"]["toks"], 2 * gap)
    print(f"[steps host] {name} ({cfg.num_layers} layers, {str(dtype)[6:]}): a SGD-M step, the prefill and 8 decode "
          f"steps card against host within {'the CPU tests bounds' if f32 else '4 bf16 steps'} (largest "
          f"{worst:.3f} of it); greedy tokens equal for {agree} of 8 steps before a near-tie")


def phase_steps(dev, smi: str) -> dict:
    """Phase 14, the step factories, optimizers, checkpoints and the train
    and serve CLIs (A10c), each CLI through its main(argv) in process:

    (a) serve gemma2-27b at its published width and full depth (46 layers,
        B = 2, a prompt of 4,096, 16 tokens): the prefill and the first 4
        decode steps against a forward over the prompt and the tokens so
        far; phi3-mini-3.8b at full depth (32 layers, B = 4, a prompt of 64,
        32 tokens), every decode step so;
    (b) train phi3-mini-3.8b with AdamW at full width and depth, 3 steps, B
        = 4, S = 128: finite losses, every leaf moved, the peak, each step's
        loss and gradient, clip and update;
    (c) the checkpoint: phi3-smoke trained 3 steps with --ckpt-dir, loaded
        back on the card bit for bit; zlib's rate on a 100 MB bf16 leaf;
    (d) the c2dfb CLI on qwen2-smoke with kernel_topk: B1 bf16 launches, the
        wire bytes against the host's run, finite val-losses;
    (e) card against host at smoke size: f32 phi3-, gemma2-, mamba2- and
        mixtral-smoke (a SGD-M step, the prefill, 8 decode steps), and
        phi3-smoke in bf16.

    Returns (d)'s B1 launches and each run's wall and peak."""
    t_phase = time.perf_counter()
    gemma = serve_consistency("serve gemma2", GEMMA_SERVE, smi, checks=4, dev=dev)
    # phi3 at 32 layers: its bf16 decode parts from the forward by more than the dense bound (4.45 steps at
    # decode step 0 on an H100): the two round different operator orders (a 4-row decode product against a
    # 384-row one) through every layer; the f32 check holds the decode path sharply
    phi3 = serve_consistency("serve phi3", PHI3_SERVE, smi, checks=31, steps=A10B_STEPS, f32=True, dev=dev)
    print(f"[steps] (a) in {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    train = train_full(smi, dev)
    print(f"[steps] (b) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ckpt = checkpoint_on_card(smi, dev)
    print(f"[steps] (c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = c2dfb_cli(smi, dev)
    print(f"[steps] (d) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name in ("phi3-mini-3.8b", "gemma2-27b", "mamba2-2.7b", "mixtral-8x7b"):
        steps_card_against_host(name, torch.float32, dev)
    steps_card_against_host("phi3-mini-3.8b", torch.bfloat16, dev)
    print(f"[steps] (e) in {time.perf_counter() - t0:.1f} s; phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return dict(cli_launches=launches, gemma_serve=gemma, phi3_serve=phi3, train=train, ckpt=ckpt)


# phase 15: launch planning (A10d): the dry run over the fake 256- and 512-rank meshes, rank 0 of a 16 x 16 step
# run for real, and the host mesh
PLAN_LAYERS = 1  # (a)'s depth: one repeat of each pattern (the widths are the configs')
PLAN_CASES = [("phi3-mini-3.8b", "train_4k", v) for v in ("baseline", "remat_dots", "moe_local", "moe_local_dots")] + [
    ("phi3-mini-3.8b", "prefill_32k", "baseline"),
    ("phi3-mini-3.8b", "decode_32k", "baseline"),
    ("phi3-mini-3.8b", "decode_32k", "decode_stationary"),
    ("gemma2-27b", "decode_32k", "baseline"),
    ("gemma2-27b", "long_500k", "baseline"),
    ("gemma2-27b", "long_500k", "decode_stationary"),
    ("mixtral-8x7b", "train_4k", "moe_local"),
    ("mamba2-2.7b", "long_500k", "baseline"),
    ("seamless-m4t-medium", "prefill_32k", "baseline"),
    ("llama-3.2-vision-11b", "prefill_32k", "baseline"),
    ("qwen2-7b", "train_4k", "baseline"),  # 28 heads on 16: attention split by queries
    # the global MoE dispatch (one capacity, its buffer reduced over the data shards), at each shape
    ("mixtral-8x7b", "train_4k", "baseline"),
    ("mixtral-8x7b", "prefill_32k", "baseline"),
    ("mixtral-8x7b", "decode_32k", "baseline"),
    ("mixtral-8x7b", "long_500k", "baseline"),
    # Mamba-2 on each device's heads (w_in's columns permuted; the projection gathered at decode)
    ("mamba2-2.7b", "train_4k", "baseline"),
    ("mamba2-2.7b", "decode_32k", "baseline"),
    ("jamba-1.5-large-398b", "decode_32k", "baseline"),
    ("seamless-m4t-medium", "decode_32k", "baseline"),  # an encoder its decode never reads
    ("gemma2-27b", "train_4k", "remat_dots"),
]
PLAN_REAL_LAYERS = 2  # (b): train_4k, rank 0 of 16 x 16
# (b)'s models: gemma2-27b at 2 layers is one repeat, which before the vocabulary-parallel cross-entropy and
# embedding its dry run said took 164 GB of temp a device
PLAN_REAL_ARCHS = ["phi3-mini-3.8b", "gemma2-27b"]
# (b): the allocator's peak over the dry run's live-storage peak.  The dry run counts every storage the step's
# operators make, each from its operator until it is freed, so the card's peak is the same storages plus the
# allocator's 512-byte rounding and cuBLAS's workspace (tens of MB): within 5% below and 10% above.  PERF.md
# states the bound's reason.
PLAN_PEAK_BOUND = (0.95, 1.10)


class ZeroIntCollectives(TorchDispatchMode):
    """Every integer output of a functional collective zeroed: the fake
    process group moves nothing, so a gathered index tensor would hold
    whatever its memory held, and an out-of-range index stops the card.
    Operators on DTensors are left to DTensor, as the dry run's counter
    leaves them, so this mode sees the local collectives."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if "c10d_functional" in func.namespace and isinstance(out, torch.Tensor) and not out.is_floating_point():
            out.zero_()
        return out


def plan_dryrun(dev: str, smi: str) -> list:
    """(a): `PLAN_CASES` through ``dryrun.main(argv)`` with ``--mesh both``,
    fake shards on ``dev``, cut to `PLAN_LAYERS`; every record ``ok``."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M

    out = tempfile.mkdtemp(prefix="dryrun_")
    records = []
    t0 = time.perf_counter()
    for arch, shape, variant in PLAN_CASES:
        records += dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both", "--variant", variant,
                                "--out", out, "--device", dev, "--layers", str(PLAN_LAYERS)])
    wall = time.perf_counter() - t0
    print(f"[plan] constants (H100 SXM data sheet): {M.PEAK_FLOPS_BF16:.4g} FLOP/s bf16, {M.HBM_BW:.4g} B/s HBM, "
          f"{M.NVLINK_LINKS} NVLink links x {M.NVLINK_BW:.4g} B/s; this card: {smi}")
    for r in records:
        mem = r.get("memory_analysis", {})
        print(f"[plan] {r['arch']} {r['shape']} {r['variant']} {r['mesh']} ({r['layers']} layers): {r['status']}; "
              f"per device: arguments {mem.get('argument_size_in_bytes')} B, outputs {mem.get('output_size_in_bytes')}"
              f" B, temp {mem.get('temp_size_in_bytes')} B, peak {mem.get('peak_size_in_bytes')} B, FLOPs "
              f"{r.get('hlo_flops')!r}, dot bytes {r.get('hlo_bytes')!r}, collectives "
              f"{r.get('collectives', {}).get('bytes_by_kind')}, roofline {r.get('roofline')}, traced in "
              f"{r.get('trace_s')!r} s{'' if r['status'] == 'ok' else ': ' + r.get('error', '')}")
    print(f"[plan] (a) {len(records)} records in {wall:.1f} s")
    for r in records:
        if r["status"] != "ok":
            print(f"[plan] {r['arch']} {r['shape']} {r['variant']} {r['mesh']}: traceback\n{r.get('traceback')}")
    check(len(records) == 2 * len(PLAN_CASES), f"the dry run wrote {len(records)} records")
    for r in records:
        check(r["status"] == "ok", f"[plan] {r['arch']} {r['shape']} {r['variant']} {r['mesh']}: {r.get('error')}")
        check(r["chips"] == (512 if r["mesh"] == "2x16x16" else 256), f"[plan] {r['mesh']} has {r['chips']} ranks")
        check(r["hlo_flops"] > 0 and r["collectives"]["total_bytes"] > 0, f"[plan] {r['arch']} {r['shape']}: no work")
    return records


def plan_real(dev: str, arch: str) -> dict:
    """(b): ``arch``'s train_4k at `PLAN_REAL_LAYERS` layers on the 16 x 16
    mesh, rank 0: the dry run's per-device estimate on fake shards, then the
    same step on real local shards on the card (zeros; the fake process
    group's collectives move nothing, their integer outputs zeroed); the
    allocator's peak against the estimate's peak, within `PLAN_PEAK_BOUND`."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=False, device=dev)
    DR.install_activation_constraint(mesh)
    try:
        case = DR.build_case(arch, "train_4k", mesh, layers=PLAN_REAL_LAYERS)
        make, mode = DR.fake_locals(dev)
        with mode, DR.host_index_math():
            est = DR.run_case(case, dev, make)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with ZeroIntCollectives():
            real = DR.run_case(case, dev, lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        DR.uninstall_activation_constraint()
    ratio = peak / est["peak_size_in_bytes"]
    print(f"[plan] (b) {arch} train_4k, {PLAN_REAL_LAYERS} layers, rank 0 of 16 x 16: the dry run's "
          f"per-device peak {est['peak_size_in_bytes']} B (arguments {est['argument_size_in_bytes']} B, temp "
          f"{est['temp_size_in_bytes']} B, traced in {est['wall_s']!r} s); on the card the allocator's peak "
          f"{peak} B above the {base} B held before (ratio {ratio!r}), the live-storage count there "
          f"{real['peak_size_in_bytes']} B; the step ran in {real['wall_s']!r} s; FLOPs {est['flops']} both ways: "
          f"{real['flops'] == est['flops']}")
    ops = sorted(set(est["made_by_op"]) | set(real["made_by_op"]),
                 key=lambda o: -abs(est["made_by_op"].get(o, 0) - real["made_by_op"].get(o, 0)))
    diffs = ", ".join(f"{o} {est['made_by_op'].get(o, 0)} / {real['made_by_op'].get(o, 0)}" for o in ops[:10])
    print(f"[plan] (b) {arch}: bytes of the storages each operator made, fake against card, the largest "
          f"differences: {diffs}")
    check(PLAN_PEAK_BOUND[0] <= ratio <= PLAN_PEAK_BOUND[1],
          f"[plan] {arch}: the card's peak {peak} B parts from the dry run's {est['peak_size_in_bytes']} B by "
          f"{ratio!r}")
    check(real["flops"] == est["flops"] and real["collectives"] == est["collectives"],
          f"[plan] {arch}: the real step's FLOPs or collectives differ from the dry run's")
    return dict(estimate=est["peak_size_in_bytes"], peak=peak, ratio=ratio, wall_s=real["wall_s"])


def plan_host_mesh(dev: str) -> None:
    """(c): `make_host_mesh` on this card (1 x 1, NCCL), and one SGD-M train
    step of f32 phi3-smoke on replicated DTensors over it, under the dry
    run's activation constraint, against the same step on the host's plain
    tensors: the loss, the first momentum (the clipped gradient) and the
    parameters within phase 14's bounds."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_leaves, tree_map
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh, release
    from repro_torch.models import steps as ST
    from repro_torch.models import transformer as PT

    cfg = dataclasses.replace(get_config("phi3-mini-3.8b", smoke=True), dtype=torch.float32)
    host = PT.init_lm_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    lr = 1e-2
    step, opt = ST.make_train_step(cfg, "sgd", lr=lr)
    hp, hs, hm = step(tree_map(lambda v: v.clone(), host), opt.init(host), batch)
    mesh = make_host_mesh(device=dev)
    check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"), f"[plan] host mesh {mesh}")
    DR.install_activation_constraint(mesh)
    try:
        def on_mesh(v):
            return DTensor.from_local(v.to(dev, copy=True), mesh, [Replicate(), Replicate()], run_check=False)

        state = opt.init(host)
        state = state._replace(m=tree_map(on_mesh, state.m))
        with implicit_replication():
            cp, cs, cm = step(tree_map(on_mesh, host), state, {k: on_mesh(v) for k, v in batch.items()})
    finally:
        DR.uninstall_activation_constraint()
        release()

    def local(t):
        return (t.to_local() if isinstance(t, DTensor) else t).cpu()

    worst = 0.0
    for what, got, want, atol in [("loss", [cm["loss"]], [hm["loss"]], TOL["atol"]),
                                  ("gradient", tree_leaves(cs.m), tree_leaves(hs.m), GRAD_ATOL["dense"]),
                                  ("parameters", tree_leaves(cp), tree_leaves(hp),
                                   TOL["atol"] + lr * GRAD_ATOL["dense"])]:
        for a, b in zip(got, want):
            err = (local(a) - b).abs()
            lim = atol + TOL["rtol"] * b.abs()
            worst = max(worst, float((err / lim).max()))
            check(bool((err <= lim).all()), f"[plan] (c) {what}: the host mesh's step parts from the host's")
    print(f"[plan] (c) host mesh {mesh}: phi3-smoke f32 SGD-M step, card through the mesh against the host: loss "
          f"{float(local(cm['loss']))!r} vs {float(hm['loss'])!r}, worst error over its bound {worst!r}")


def phase_plan(dev: str, smi: str) -> dict:
    """Phase 15, launch planning (A10d): (a) the dry run in process through
    ``dryrun.main(argv)`` at full width on both production meshes (fake
    ranks, fake shards on the card); (b) rank 0 of a 16 x 16 train step run
    for real (phi3-mini and gemma2-27b, `PLAN_REAL_ARCHS`), each peak
    against the dry run's; (c) the host mesh on this card, a smoke train
    step through it against the host."""
    from repro_torch.launch.mesh import release

    t0 = time.perf_counter()
    try:
        records = plan_dryrun(dev, smi)
        real = {}
        for arch in PLAN_REAL_ARCHS:
            real[arch] = plan_real(dev, arch)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        release()
    plan_host_mesh(dev)
    print(f"[plan] phase 15 in {time.perf_counter() - t0:.1f} s")
    return dict(records=len(records), real=real)


# phase 16: the nine examples' twins, each through its main(argv) at its own sizes ("{out}": a temporary directory)
EXAMPLES = ROOT / "examples"
EXAMPLE_ARGS = {
    "quickstart": [],
    "coefficient_tuning": ["--fast"],
    "hyper_representation": ["--fast"],
    "wan_bilevel": ["--out", "{out}"],
    "async_bilevel": ["--out", "{out}"],
    "observability": ["--out", "{out}"],
    "transport_backends": [],
    "serve_batch": [],
    "decentralized_llm_bilevel": [],  # the 20m preset, its 30 steps
}
# the twins whose printed lines are held card against host, and how: the
# device transport's host wall left out, megabytes of exact bytes equal
EXAMPLES_ON_HOST = ("wan_bilevel", "transport_backends")
EXAMPLE_MACHINE = [r"wall_s=([\d.]+)"]
EXAMPLE_EXACT = [r"[\d.]+ MB"]


def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_run(name: str, argv: list) -> tuple[str, float]:
    """The twin's ``main(argv)`` in process: what it printed, and its wall
    seconds to a synchronized card."""
    main = _load_example(f"{name}_torch").main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def phase_examples(dev: str, smi: str) -> dict:
    """Phase 16: each example's twin on the card (see the module docstring).
    Returns each twin's kernel launch counts (``_build.LAUNCHES``)."""
    from repro_torch.core import selection
    from repro_torch.kernels import _build

    compare = _load_example("_compare_torch").compare_printed
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        for name, args in EXAMPLE_ARGS.items():
            argv = [a.format(out=str(Path(tmp) / name)) for a in args]
            host = ""
            if name in EXAMPLES_ON_HOST:
                log = []
                with selection.recorded(log):
                    want, host_wall = _example_run(name, argv + ["--device", "cpu"])
                seen = selection.Partings()
                _build.reset_launch_counts()
                with selection.compared([(r.to(dev), k.to(dev)) for r, k in log], seen):
                    got, wall = _example_run(name, argv + ["--device", dev])
                # floats only while the runs have not parted: every line prints after the last round
                problems = compare(want, got, machine=EXAMPLE_MACHINE, exact=EXAMPLE_EXACT, floats=seen.first is None)
                check(not problems, f"{name}: the card's lines differ from the host's:\n" + "\n".join(problems))
                apart = ("never part: integers and floats held" if seen.first is None else
                         f"first part at compression {seen.first} ({seen.rows} row(s), the k-th and (k+1)-th "
                         f"magnitudes {seen.rel_gap:.2e} apart: a near-tie; every residual up to it within the "
                         f"golden tolerance): integers held")
                host = (f"; the host's lines in {host_wall:.3f} s; the card's and the host's {seen.compressions} "
                        f"top-k selections {apart}")
            else:
                _build.reset_launch_counts()
                got, wall = _example_run(name, argv + ["--device", dev])
            launches[name] = _build.launch_counts()
            for line in got.splitlines():
                print(f"[ex {name}] {line}")
            print(f"[examples] {name}: {wall:.3f} s wall on the card, launches {launches[name]}{host}; {smi}")
            check(got.strip(), f"{name} printed nothing")
            check(not any(launches[name].values()),
                  f"{name} launched {launches[name]}: no kernel of this repo is on the examples' top-k paths")
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[examples] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def _to(tree, dev):
    from repro_torch.transport.device import _on

    return _on(tree, torch.device(dev))


def run_only(dev, only: list) -> int:
    """``--only c4,transport,lm,archs,steps,plan,examples``: the named checks
    alone, in that order, after the build (for working on one of them): "c4"
    phase 4's kernel_topk run and phase 11's fused round on its states,
    "transport" phase 4's kernel_topk run and phase 11, "lm" phase 12,
    "archs" phase 13, "steps" phase 14, "plan" phase 15, "examples" phase
    16.  No result lines."""
    for name in only:  # in the order given
        if name in ("c4", "transport"):
            bundle = build_task(dev)
            *_, main_mets = phase_main_path(dev, bundle, CFG, "block_topk")
            if name == "c4":
                fused_on_run_states(dev, bundle, main_mets)
            else:
                print(f"[only] phase 11: {phase_transport(dev, bundle, main_mets)}")
            del bundle
        elif name == "lm":
            print(f"[only] phase 12: {phase_lm(dev)}")
        elif name == "archs":
            print(f"[only] phase 13: {phase_archs(dev)}")
        elif name == "steps":
            print(f"[only] phase 14: {phase_steps(dev, nvidia_smi())}")
        elif name == "plan":
            print(f"[only] phase 15: {phase_plan(dev, nvidia_smi())}")
        elif name == "examples":
            print(f"[only] phase 16: {phase_examples(dev, nvidia_smi())}")
        else:
            fail(f"--only takes c4, transport, lm, archs, steps, plan and examples, not {name!r}")
    print(f"[only] {only} passed")
    return 0


def main() -> int:
    only = sys.argv[2].split(",") if sys.argv[1:2] == ["--only"] else None
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
    if only:
        return run_only(dev, only)

    # 3. kernels at main-path shapes (and B2 and B3 at phase 11's stacked shapes)
    stacked = transport_kernel_times(dev)
    kernels = phase_kernels(dev)
    kernels["unpack_sparse_blocks_into"] = stacked.pop("unpack_sparse_blocks_into")
    for name, entry in stacked.items():
        kernels[name]["transport"] = entry
    for entry, fn in [(kernels[n], f) for n, f in MAIN_INSTANCES.items()] + [
        (kernels["quantize"]["bf16"], QUANT_BF16_INSTANCE)
    ]:
        found = [v for (_, f), v in ptxas.items() if f == fn]
        check(len(found) == 1, f"ptxas reported no kernel {fn}")
        entry["registers"], st, ld = found[0]
        entry["spill_bytes"] = st + ld
    # 4. main paths: kernel_topk, then kernel_quant on the same task (f32 leaves)
    bundle = build_task(dev)
    state, cfg, topo, counts, main_mets = phase_main_path(dev, bundle, CFG, "block_topk")
    kernels["block_topk"]["launches"] = counts["block_topk"]
    gen = torch.Generator(device=dev).manual_seed(0)
    qstate, qcfg, _, counts, _ = phase_main_path(dev, bundle, CFG_QUANT, "quantize", gen)
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
    # 9. small input, card against host (with a fabric and a schedule, and async too)
    phase_small_input(dev)
    # 10. the compiled runtime: each branch's round body captured once and replayed
    com = phase_compiled(dev, bundle)
    kernels["block_topk"]["compiled_launches"] = com["block_topk"]
    kernels["quantize"]["compiled_launches"] = com["quantize"]
    # 11. the transports: the fused and dense device exchange, card against host, B2 and B3 at the stacked shapes;
    # every B3 launch of the fused run is the leaf entry's (the profiled round counts them by kernel name)
    transport = phase_transport(dev, bundle, main_mets)
    kernels["unpack_sparse_blocks_into"]["launches"] = transport.pop("unpack_sparse_blocks")
    for name, n in transport.items():
        kernels[name]["transport_launches"] = n
    del bundle
    # 12. the dense LM bilevel run: phi3-mini at its published width, bf16 leaves through B1 and B4 on a main path
    lm = phase_lm(dev)
    kernels["block_topk"]["bf16"]["lm_head"] = lm["times"]["block_topk_bf16"]
    kernels["quantize"]["bf16"]["lm_head"] = lm["times"]["quantize_bf16"]
    kernels["pack_sparse_blocks"]["lm_head"] = lm["times"]["pack_sparse_blocks"]
    kernels["block_topk"]["bf16"]["bf16_phase_launches"] = kernels["block_topk"]["bf16"]["launches"]
    kernels["quantize"]["bf16"]["bf16_phase_launches"] = kernels["quantize"]["bf16"]["launches"]
    kernels["block_topk"]["bf16"]["launches"] = lm["block_topk_bf16"]
    kernels["quantize"]["bf16"]["launches"] = lm["quantize_bf16"]
    for name in ("pack_sparse_blocks", "unpack_sparse_blocks"):
        if name in lm:
            kernels[name if name == "pack_sparse_blocks" else "unpack_sparse_blocks_into"]["lm_launches"] = lm[name]
    # 13. the MoE, Mamba-2 and multimodal paths: C2DFB on mamba2-2.7b at its published width, bf16 leaves beside f32
    # ones; launches under new keys (the counts above stay phase 12's)
    archs = phase_archs(dev)
    kernels["block_topk"]["bf16"]["mamba2_launches"] = archs["block_topk_bf16"]
    kernels["block_topk"]["mamba2_launches"] = archs["block_topk_f32"]
    kernels["quantize"]["bf16"]["mamba2_launches"] = archs["quantize_bf16"]
    kernels["pack_sparse_blocks"]["mamba2_launches"] = archs["pack_sparse_blocks"]
    # 14. the steps, optimizers, checkpoints and the train and serve CLIs at full width: the c2dfb CLI's B1 bf16
    # launches under a new key
    steps = phase_steps(dev, smi)
    kernels["block_topk"]["bf16"]["cli_launches"] = steps["cli_launches"]
    # 15. launch planning: the dry run on the fake 256- and 512-rank meshes, rank 0 of a 16 x 16 step for real,
    # the host mesh (no kernel of this repo on its path)
    phase_plan(dev, smi)
    # 16. the nine examples' twins at their own sizes: their launches under a new key, by twin (B3's tile and leaf
    # entries share one counter)
    examples = phase_examples(dev, smi)
    for entry, counter in [(kernels["block_topk"], "block_topk"), (kernels["block_topk"]["bf16"], "block_topk_bf16"),
                           (kernels["pack_sparse_blocks"], "pack_sparse_blocks"),
                           (kernels["unpack_sparse_blocks"], "unpack_sparse_blocks"),
                           (kernels["unpack_sparse_blocks_into"], "unpack_sparse_blocks"),
                           (kernels["quantize"], "quantize"), (kernels["quantize"]["bf16"], "quantize_bf16")]:
        entry["examples_launches"] = {name: counts[counter] for name, counts in examples.items()}

    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
