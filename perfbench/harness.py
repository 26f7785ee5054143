"""One run of one cell: set-up, the measured window, the traced window and
the check of what the window's rounds produced.

Set-up builds the cell's problem from the seed through the program's own
builders, starts C²DFB (`init_state`), and drives that state through its
first ``CHECK_ROUNDS`` rounds with the window's own call
(``repro_torch.core.c2dfb.c2dfb_round``); the first round traces the
oracles and warms every shape the window uses.  What the start and
those rounds produced (the first gradients the rounds consume: the
hypergradient u0 and the two inner loops' gradients; each round's
hypergradient norm and wire bytes; every state leaf's change over the
three, and the upper level's change itself where the family names it) is
kept for the check, with the precision settings those rounds ran under.
The window then loops the same call on the same state, back to back, a
CUDA event at each round's end, until ``seconds`` of host time have
passed, and synchronises once.

After the window, the program's state is freed and the plain reference
(`perfbench.reference`) runs the same ``CHECK_ROUNDS`` rounds from the
seed, and `compare` holds the program's numbers to it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import math
import statistics
import sys
import time
import types

import torch

from perfbench import faults, spec, trace as tracing
from perfbench.reference import c2dfb as plain

CHECK_ROUNDS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; float32 outside the tensor cores
DRAW_SALT = 0x5EED  # the compressors' draws: a generator of their own, seeded seed + DRAW_SALT
COMPRESSOR_KIND = {"kernel_topk": "topk", "block_topk": "topk", "kernel_quant": "quant"}
# the settings that choose how float32 and reduced-precision products are
# computed, on cuBLAS's and cuDNN's side each, as far as torch has them
PRECISION_FLAGS = ("allow_tf32", "fp32_precision", "allow_bf16_reduced_precision_reduction",
                   "allow_fp16_reduced_precision_reduction")


def family(config: dict):
    return importlib.import_module(f"perfbench.families.{config['family']}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def matmul_flags() -> dict:
    """The process's precision settings for products, as they stand: the
    check rounds and the window must run under the same ones."""
    out = {"float32_matmul_precision": torch.get_float32_matmul_precision()}
    for owner, obj in (("matmul", torch.backends.cuda.matmul), ("cudnn", torch.backends.cudnn)):
        for name in PRECISION_FLAGS:
            try:
                if hasattr(obj, name):
                    out[f"{owner}.{name}"] = getattr(obj, name)
            except RuntimeError as e:  # set through the other of torch's two APIs
                out[f"{owner}.{name}"] = f"unreadable: {e}"
    return out


# ---------------------------------------------------------------- trees


def flatten(tree, prefix: str = "") -> dict:
    """A nested tree as ``path -> leaf`` (paths joined by ".")."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return out


def state_leaves(state) -> dict:
    """Every leaf of the program's C2DFBState by ``<tree>/<path>``, as
    `plain.State.trees` names the reference's."""
    out = {}
    for name in ("x", "s_x", "u_prev"):
        out.update({f"{name}/{k}": v for k, v in flatten(getattr(state, name)).items()})
    for loop, inner in (("y", state.inner_y), ("z", state.inner_z)):
        for field in ("d", "d_hat", "s", "s_hat", "g_prev"):
            out.update({f"{loop}.{field}/{k}": v for k, v in flatten(getattr(inner, field)).items()})
    return out


GRADIENT_TREES = ("u_prev/", "y.g_prev/", "z.g_prev/")


def _grads(leaves: dict) -> dict:
    return {k: plain.norm(v) for k, v in leaves.items() if k.startswith(GRADIENT_TREES)}


class Snapshot:
    """The start state's leaves on the host (each distinct tensor once), to
    take every leaf's change after the check rounds without holding a
    second state on the device."""

    def __init__(self, leaves: dict):
        held, self.names = {}, {}
        for k, v in leaves.items():
            key = (v.data_ptr(), tuple(v.shape), v.dtype)
            if key not in held:
                held[key] = v.detach().to("cpu", copy=True)
            self.names[k] = key
        self.held = held

    def steps(self, leaves: dict, prefixes: tuple) -> dict:
        """The change of each leaf under ``prefixes``, as a float32 tensor on
        the host."""
        return {k: (leaves[k].to(torch.float32) - self.held[key].to(leaves[k].device).to(torch.float32)).cpu()
                for k, key in self.names.items() if k.startswith(prefixes)}

    def change(self, leaves: dict) -> dict:
        by_key: dict = {}
        for k, key in self.names.items():
            by_key.setdefault(key, []).append(k)
        out = {}
        for key, names in by_key.items():
            start = self.held[key].to(leaves[names[0]].device).to(torch.float32)
            for k in names:
                out[k] = plain.norm(leaves[k].to(torch.float32) - start)
            del start
        return out


# ---------------------------------------------------------------- the program


def build_program(config: dict, workload: dict, seed: int, device, plant=()) -> dict:
    """The program's problem, graph, settings, start, mixing matrix, draw
    source and round call, faults planted where asked."""
    from repro_torch.core import c2dfb

    fam = family(config)
    prog = fam.program(config, workload, seed, device)
    prog["step_trees"] = getattr(fam, "STEP_TREES", ())
    prog["W"] = torch.as_tensor(prog["topo"].W, dtype=torch.float32, device=device)
    prog["generator"] = torch.Generator(device=device).manual_seed(seed + DRAW_SALT)
    prog["round"] = lambda *a, **k: c2dfb.c2dfb_round(*a, **k)
    return faults.plant(prog, plant)


def step(prog: dict, state):
    return prog["round"](state, prog["generator"], prog["problem"], prog["topo"], prog["cfg"], W=prog["W"])


def check_rounds(prog: dict, tf32: bool = False) -> tuple[object, dict]:
    """Start C²DFB and run the check rounds; returns the state and what the
    check compares (host numbers).  The rounds run under the process's own
    precision settings, as the window does; ``tf32`` (the calibration's
    control, never a benchmark run) turns TF32 products on for them."""
    from repro_torch.core.c2dfb import init_state

    with plain.products(plain.Precision(products="tf32")) if tf32 else contextlib.nullcontext():
        flags = matmul_flags()
        state = init_state(prog["problem"], prog["cfg"], prog["x0"], prog["y0"])
        start = state_leaves(state)
        rec = {"hypergrad_norm": [], "measured_bytes": [], "grads": _grads(start), "flags": flags}
        snap = Snapshot(start)
        del start
        for _ in range(CHECK_ROUNDS):
            state, met = step(prog, state)
            rec["hypergrad_norm"].append(float(met["hypergrad_norm"]))
            rec["measured_bytes"].append(int(met["measured_bytes"]))
        leaves = state_leaves(state)
        rec["change"] = snap.change(leaves)
        rec["steps"] = snap.steps(leaves, prog["step_trees"])
        del leaves
    return state, rec


# ---------------------------------------------------------------- the reference


def reference_rounds(config: dict, workload: dict, seed: int, device, precision: plain.Precision) -> dict:
    """The plain reference's check rounds from the seed."""
    fam = family(config)
    c = spec.c2dfb_settings(config, workload)
    if not c.get("scale_eta_y", True):
        raise ValueError("the plain rounds take the y loop's step as eta_in / (1 + lam)")
    nodes = {**config, **workload}
    comp = plain.Compressor(kind=COMPRESSOR_KIND[c["compressor"]], ratio=c.get("comp_ratio", 0.2),
                            bits=c.get("comp_bits", 4), block=c.get("comp_block", 1024),
                            generator=torch.Generator(device=device).manual_seed(seed + DRAW_SALT))
    settings = plain.Settings(**{k: c[k] for k in ("lam", "eta_out", "gamma_out", "eta_in", "gamma_in", "K")})
    with plain.products(precision):
        oracles, x0, y0 = fam.reference(config, workload, seed, device, precision)
        rnd = plain.Round(oracles, plain.graph_weights(nodes["topology"], nodes["nodes"]), settings, comp,
                          precision, device)
        state = rnd.init(x0, y0)
        before = state.trees()
        rec = {"hypergrad_norm": [], "measured_bytes": [], "grads": _grads(before)}
        for _ in range(CHECK_ROUNDS):
            state, met = rnd.step(state)
            rec["hypergrad_norm"].append(met["hypergrad_norm"])
            rec["measured_bytes"].append(met["measured_bytes"])
        after = state.trees()
        rec["change"] = plain.change_norms(before, after)
        rec["steps"] = {k: (after[k].to(torch.float32) - before[k].to(torch.float32)).cpu()
                        for k in after if k.startswith(getattr(fam, "STEP_TREES", ()))}
    return rec


def precision_of(config: dict) -> plain.Precision:
    """The reference's precision: float32 products with TF32 off, the state
    stored as the configuration states."""
    return plain.Precision(storage=family(config).STORAGE)


# ---------------------------------------------------------------- the check


def _worst_leaf(prog: dict, ref: dict) -> tuple[float, str]:
    """The largest gap between a leaf's norm on the two sides, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; and the leaf."""
    floor = statistics.median(ref.values())
    worst, at = 0.0, ""
    for k, r in ref.items():
        gap = abs(prog[k] - r)
        den = max(r, floor)
        v = gap / den if den > 0 else (0.0 if gap == 0 else math.inf)
        if not v <= worst:
            worst, at = v, k
    return worst, at


def _direction_gap(prog: dict, ref: dict) -> float:
    """1 - cos of the angle between the program's and the reference's
    change of the listed leaves, taken as one vector: 0 where they point
    the same way, 2 where one is the other negated."""
    dot = sum(float(torch.sum(prog[k].double() * ref[k].double())) for k in ref)
    na = math.sqrt(sum(float(torch.sum(prog[k].double() ** 2)) for k in ref))
    nb = math.sqrt(sum(float(torch.sum(ref[k].double() ** 2)) for k in ref))
    if na == 0 or nb == 0:
        return 0.0 if na == nb else 1.0
    return 1.0 - dot / (na * nb)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the check holds to their limits:

    * ``loss_gap``: the first round's hypergradient norm (later rounds'
      swing with the top-k selections that part at near-ties);
    * ``grad_gap``: the first gradients (u0, each loop's first gradient),
      by the worst leaf;
    * ``change_gap``: every state leaf's change over the check rounds
      (x, s_x, and each loop's d, d_hat, s, s_hat), by the worst leaf;
    * ``bytes_gap``: each round's wire bytes, the worst round;
    * ``step_dir_gap`` (where the family names its ``STEP_TREES``, the
      upper level's: a gap of norms cannot see an update of the right size
      that points the wrong way): 1 - cos between the two sides' change of
      those leaves over the check rounds."""
    def rel(a, b):
        return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)

    grads, grads_at = _worst_leaf(prog["grads"], ref["grads"])
    moved = {k: v for k, v in ref["change"].items() if not k.startswith(GRADIENT_TREES)}
    change, change_at = _worst_leaf(prog["change"], moved)
    out = {
        "loss_gap": rel(prog["hypergrad_norm"][0], ref["hypergrad_norm"][0]),
        "grad_gap": grads,
        "change_gap": change,
        "bytes_gap": max(rel(a, b) for a, b in zip(prog["measured_bytes"], ref["measured_bytes"])),
        "_at": {"grad_gap": grads_at, "change_gap": change_at},
    }
    if ref.get("steps"):
        out["step_dir_gap"] = _direction_gap(prog["steps"], ref["steps"])
    return out


# ---------------------------------------------------------------- a run


def _window(prog: dict, box: dict, seconds: float, device) -> dict:
    """The measured window on ``box["state"]``, which it advances: the box
    is the state's only holder, so no earlier round's state stays alive."""
    cuda = device.type == "cuda"
    ends, dispatch, norms = [], [], []
    flags = matmul_flags()
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    marks = [t0]
    while True:
        th = time.perf_counter()
        box["state"], met = step(prog, box["state"])
        dispatch.append(time.perf_counter() - th)
        norms.append(met["hypergrad_norm"])
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        else:
            marks.append(time.perf_counter())
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if cuda:
        round_ms = [a.elapsed_time(b) for a, b in zip([start] + ends[:-1], ends)]
    else:
        round_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    failed = sum(1 for v in torch.stack(norms).tolist() if not math.isfinite(v))
    return {"rounds": len(round_ms), "wall_s": wall, "round_ms": round_ms, "dispatch_s": dispatch, "failed": failed,
            "flags": (flags, matmul_flags())}


def _p90(values: list) -> float | None:
    """The 90th percentile, where at least ten rounds lie beyond it."""
    if len(values) < 100:
        return None
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def _compressed_leaves(prog: dict) -> list:
    """(elements over all nodes, bytes an element) of every leaf the
    compressors read: the lower level's tree."""
    return [(v.numel(), v.element_size()) for v in flatten(prog["y0"]).values()]


def run_cell(config: dict, workload: dict, seed: int, seconds: float, trace: bool, device, metrics: list,
             t_start: float, limits: dict | None = None) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    fam = family(config)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    prog = build_program(config, workload, seed, device)
    t1 = time.perf_counter()
    state, rec = check_rounds(prog)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"[setup] {setup_s:.3f} s: imports {t0 - t_start:.3f}, problem {t1 - t0:.3f}, start and "
        f"{CHECK_ROUNDS} rounds {time.perf_counter() - t1:.3f}; peak {setup_peak} bytes; hypergrad_norm "
        f"{rec['hypergrad_norm']}, measured_bytes {rec['measured_bytes']}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    flops = fam.model_flops(config, workload, prog["problem"])
    storage = fam.STORAGE
    box, tr = {"state": state}, None
    del state
    if trace:
        traced = workload["trace_rounds"]

        def one():
            box["state"], _ = step(prog, box["state"])

        tr = tracing.profile_rounds(one, traced, device)
        log(f"[trace] {traced} rounds in {tr.window_s:.3f} s, {len(tr.device)} device activities")
    win = _window(prog, box, seconds, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(setup_peak, window_peak)
    log(f"[window] {win['rounds']} rounds in {win['wall_s']:.3f} s; peak {window_peak} bytes (set-up and window "
        f"{peak})")
    compressed, nodes = _compressed_leaves(prog), prog["W"].shape[0]
    c = spec.c2dfb_settings(config, workload)
    del box, prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = reference_rounds(config, workload, seed, device, precision_of(config))
    log(f"[check] the reference's {CHECK_ROUNDS} rounds in {time.perf_counter() - t0:.3f} s")
    gaps = compare(rec, ref)
    at = gaps.pop("_at")
    limits = workload["limits"] if limits is None else limits
    checks = {k: {"value": gaps[k], "limit": v} for k, v in limits.items()}
    # the window's precision settings, at its start and at its end, against
    # the check rounds': a product the window computes more coarsely than the
    # checked rounds did would pass unseen
    changed = sorted({k for f in win["flags"] for k in set(f) | set(rec["flags"]) if f.get(k) != rec["flags"].get(k)})
    if changed:
        log(f"[check] precision settings of the check rounds {rec['flags']}, of the window {win['flags']}")
    checks["flags_changed"] = {"value": len(changed), "limit": 0}
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and win["failed"] == 0
    for k, v in checks.items():
        where = f" (leaf {at[k]})" if k in at else ""
        log(f"[check] {k} {v['value']!r} limit {v['limit']!r}{where}")

    values = {}
    if not trace:
        values = {"round_ms": win["wall_s"] * 1e3 / win["rounds"], "round_ms_p90": _p90(win["round_ms"]),
                  "peak_gb": peak / 1e9, "setup_s": setup_s}
    else:
        ctx = types.SimpleNamespace(trace=tr, window=win, flops_per_round=flops, peak_flops=PEAK_FLOPS[storage],
                      hbm_bytes_per_s=HBM_BYTES_PER_S, compressed=compressed, nodes=nodes, K=c["K"],
                      block=c.get("comp_block", 1024), compressor=c["compressor"])
        for m in metrics:
            mod = importlib.import_module(f"perfbench.metrics.{m['name']}")
            values[m["name"]] = mod.read(ctx)
    units = {m["name"]: m["unit"] for m in metrics}
    out = {"correct": correct, "attempted": win["rounds"], "failed": win["failed"],
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units and v is not None},
           "device": device_info(device, peak)}
    if trace:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": peak}


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
