#!/usr/bin/env python3
"""Drive the PyTorch port of C2DFB on one CUDA card and hold every kernel
against its plain PyTorch version.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure ends the run with a non-zero exit and no result line):

1. environment: versions, card name and power limit, TF32 off;
2. build: nvcc compiles every kernel source of src/repro_torch/kernels/csrc;
3. kernels at the main path's shapes, each against its plain version on the
   card (bit-exact), timed (device time by torch.profiler, call time by CUDA
   events) beside its memory bound and, where one exists, a PyTorch library
   call computing the same function;
4. main path: synchronous C2DFB on the 20 Newsgroups-width coefficient-tuning
   task (p = 101,631, c = 20, m = 10 nodes on a ring, label skew 0.8,
   n = 2,000 synthetic documents), K = 10, kernel_topk, T = 3 rounds; block
   top-k must launch exactly 4*K*T times; then one more round is timed and
   profiled (device busy share, device time by kernel);
5. wire bytes: round_wire_bytes_measured on the final state (the pack kernel
   launches 4*m times); every block-sparse payload equals the sparse codec's
   byte string and the unpack kernel decodes every pack back;
6. small input: the same algorithm on a small task through the kernels and
   through the plain versions on the host, which must agree.

The last lines are a {"kernels": [...]} record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet; the bound of every kernel here
TOL = dict(rtol=1e-4, atol=1e-6)

# main-path configuration: the paper's coefficient-tuning width (20 Newsgroups)
TASK = dict(m=10, n=2000, p=101631, c=20, h=0.8, seed=0)
CFG = dict(K=10, compressor="kernel_topk", comp_ratio=0.2, comp_block=1024)
T = 3


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


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.pack_residuals import (
        pack_sparse_blocks,
        pack_sparse_blocks_ref,
        unpack_sparse_blocks,
        unpack_sparse_blocks_ref,
    )
    from repro_torch.kernels.ref import block_topk_ref
    from repro_torch.kernels.topk_compress import block_topk_kernel

    m, p, c, block = TASK["m"], TASK["p"], TASK["c"], CFG["comp_block"]
    nb_node = -(-p * c // block)  # 1,985 blocks a node
    rows = m * nb_node            # 19,850 rows a top-k launch
    k = max(1, int(round(CFG["comp_ratio"] * block)))
    gen = torch.Generator(device=dev).manual_seed(0)
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
            library_ms=timed(lib, iters=5)["ms"],
        )
        print(f"[kernels] block_topk {name} ({rows}, {block}) k={k}: {topk[name]}")
    q_all = block_topk_kernel(x, k)
    res["block_topk"] = dict(
        name="block_topk", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/topk_compress.cu",
        replaces="src/repro/kernels/topk_compress.py:53",
        shape=[rows, block], k=k,
        max_abs_err=topk["f32"]["max_abs_err"], ms=topk["f32"]["ms"],
        call_ms=topk["f32"]["call_ms"], timer=topk["f32"]["timer"],
        plain_ms=topk["f32"]["plain_ms"], bound_ms=topk["f32"]["bound_ms"],
        bound_by="bytes", library_ms=topk["f32"]["library_ms"],
        library="exact top-k: torch.topk + scatter (not bisection)",
        bf16={kk: topk["bf16"][kk] for kk in ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "library_ms")},
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
        name="pack_sparse_blocks", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/pack_residuals.cu",
        replaces="src/repro/kernels/pack_residuals.py:71",
        shape=[nb_node, block], k=kk, kpad=kpad,
        max_abs_err=float((vals - rvals).abs().max()),
        **timed(lambda: pack_sparse_blocks(q, kk, block)),
        plain_ms=timed(lambda: pack_sparse_blocks_ref(q, kk, block), iters=5)["ms"],
        bound_ms=bound_ms(q.numel() * 4 + vals.numel() * 8),
        bound_by="bytes", library_ms=None,
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
        bound_by="bytes",
        library_ms=timed(
            lambda: torch.zeros((nb_node, block + 1), device=dev).scatter_add_(1, idx64, vals)
        )["ms"],
        library="torch.zeros().scatter_add_ into a sentinel column",
    )
    print(f"[kernels] unpack_sparse_blocks: {res['unpack_sparse_blocks']}")
    return res


def phase_main_path(dev):
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    bundle = coefficient_tuning_task(**TASK, device=dev)
    torch.cuda.synchronize()
    print(f"[main] task built in {time.perf_counter() - t0:.3f} s: "
          f"y {tuple(bundle.y0.shape)}, train a {tuple(bundle.problem.data_g['a'].shape)}")
    topo, cfg = ring(TASK["m"]), C2DFBConfig(**CFG)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, mets = run(bundle.problem, topo, cfg, bundle.x0, bundle.y0, T=T, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    print(f"[main] {T} rounds in {wall!r} s ({wall / T!r} s a round on average), launches {counts}, "
          f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    check(counts["block_topk"] == 4 * cfg.K * T, f"block_topk launched {counts['block_topk']} times, want {4 * cfg.K * T}")
    for k, v in mets.items():
        check(v.shape[0] == T, f"metric {k} has shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v.double()).all()), f"metric {k} is not finite: {v}")
    for leaf in (state.x, state.s_x, state.inner_y.d, state.inner_z.d):
        check(bool(torch.isfinite(leaf).all()), "state holds non-finite values")
    check(tuple(state.inner_y.d.shape) == (TASK["m"], TASK["p"], TASK["c"]), "y has the wrong shape")
    for t in range(T):
        print(f"[main] round {t}: hypergrad_norm {float(mets['hypergrad_norm'][t])!r} "
              f"measured_bytes {int(mets['measured_bytes'][t])} "
              f"x_consensus_err {float(mets['x_consensus_err'][t])!r}")
    profile_round(bundle.problem, topo, cfg, state)
    return state, cfg, topo, counts["block_topk"], wall


def profile_round(problem, topo, cfg, state) -> None:
    """One more round from the final state (outside the counted run): its
    host wall time, then a device profile of a second one — device busy
    share and the device time by kernel name."""
    from repro_torch.core.c2dfb import c2dfb_round

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2dfb_round(state, None, problem, topo, cfg)
    torch.cuda.synchronize()
    print(f"[round] steady-state round wall {time.perf_counter() - t0!r} s")
    events, wall = device_window(lambda: c2dfb_round(state, None, problem, topo, cfg), 1)
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
    print(f"[round] profiled round: wall {wall!r} s, device busy {busy / 1e6!r} s "
          f"({busy / 1e6 / wall:.3f} of the wall), {len(events)} device activities")
    for name, (us, n) in top:
        print(f"[round]   {us / 1e3:10.3f} ms  {n:5d}x  {name[:90]}")


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


def phase_small_input(dev):
    """The algorithm through the kernels (card) and through the plain
    versions (host) on one small input: the two must agree."""
    from repro_torch.core.c2dfb import C2DFBConfig, run
    from repro_torch.core.topology import ring
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.bilevel_tasks import coefficient_tuning_task

    task = dict(m=4, n=200, p=64, c=4, seed=0)
    cfg = C2DFBConfig(K=3, compressor="kernel_topk", comp_ratio=0.2, comp_block=128)
    out = {}
    for d in ("cpu", dev):
        b = coefficient_tuning_task(**task, device=d)
        out[d] = run(b.problem, ring(4), cfg, b.x0, b.y0, T=3, device=d)
    (sc, mc), (sg, mg) = out["cpu"], out[dev]
    for what, a, b in (("x", sc.x, sg.x), ("s_x", sc.s_x, sg.s_x), ("y", sc.inner_y.d, sg.inner_y.d),
                       ("z", sc.inner_z.d, sg.inner_z.d)):
        for la, lb in zip(tree_leaves(a), tree_leaves(b)):
            check(torch.allclose(lb.cpu(), la, **TOL), f"small input: {what} differs between card and host")
    check(torch.equal(mc["measured_bytes"], mg["measured_bytes"].cpu()), "small input: measured_bytes differ")
    print(f"[small] card and host agree (rtol {TOL['rtol']}, atol {TOL['atol']}); "
          f"measured_bytes {mc['measured_bytes'].tolist()}")


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
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels at main-path shapes
    kernels = phase_kernels(dev)
    # 4. main path
    state, cfg, topo, topk_launches, _ = phase_main_path(dev)
    kernels["block_topk"]["launches"] = topk_launches
    # 5. wire bytes through pack / unpack
    pack_launches, unpack_launches = phase_wire(state, cfg, topo)
    kernels["pack_sparse_blocks"]["launches"] = pack_launches
    kernels["unpack_sparse_blocks"]["launches"] = unpack_launches
    del state
    # 6. small input, card against host
    phase_small_input(dev)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
