#!/usr/bin/env python3
"""Trace which operator parts a bf16 C2DFB round on the card from the same
round on the host, operator by operator.

    python3 tools/trace_parting.py                      # jamba-smoke, m = 4, one repeat
    python3 tools/trace_parting.py --arch mixtral-8x7b --m 8 --out DIR
    python3 tools/trace_parting.py --device cpu         # a rehearsal: host against host, every distance 0

The run is chip_smoke.py's card-against-host check (`lm_card_against_host`:
B = 2, S = 32, K = 2, kernel_topk at 0.1 of blocks of 512, on a ring) at
``--m`` nodes and ``--repeats`` repeats of the smoke config's pattern.
Every distance is in bf16 steps of a scale, as that check states its
bound: max |card - host| / (2^-8 * scale).

1. **The round.**  The host steps ``--rounds`` rounds and records its top-k
   selections; the card runs each round on the host's round-t state keeping
   them.  Each field's distance (scale: the field's largest magnitude, or
   for a tracker the gradients it sums if larger).
2. **The oracles and the mixes, each given the host's inputs.**  Every
   oracle call of the host's round (a traced gradient, with its inputs and
   outputs) is run again on the card on the host's inputs, and so is every
   mix; each output's distance in steps of its own scale.
3. **The operators of an oracle call, each given the host's inputs.**  The
   call is the worst one of the oracle that feeds the field that parts most
   (or ``--field``): the y loop's gradient of h for y and y_s, the z loop's
   of g for z and z_s, the x-partials for x, s_x and u.  Its gradient graph
   (``make_fx``, the seed rewritten as the oracles' graphs have it) runs
   node by node on the host; every node runs again on the card on the
   host's values of its inputs.  The nodes with the largest distances are
   printed with their inputs' shapes, and the distances are summed up by
   operator.
4. **Which operator moves the output.**  For each operator that differs at
   all in 3, the graph runs once more on the host with only that
   operator's nodes computed on the card (their inputs the chain's own
   values): the output's distance is what that operator's rounding alone
   does to the gradient.  Beside it, the graph run wholly on the card.

``--out DIR`` writes the tables as JSON (``trace_parting.json``)."""

from __future__ import annotations

import argparse
import collections
import dataclasses
import inspect
import json
import operator
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import c2dfb as C  # noqa: E402
from repro_torch.core import inner_loop as IL  # noqa: E402
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.gossip import mix_delta_dense  # noqa: E402
from repro_torch.core.oracle_graph import OracleGraphs, _seed_without_loss  # noqa: E402
from repro_torch.core.topology import ring  # noqa: E402
from repro_torch.core.types import tree_leaves, tree_map  # noqa: E402

STEP = 2.0 ** -8
# the oracles whose outputs a field sums: the y loop's gradient of h = f + lam g,
# the z loop's of g, and the x-partials of the hypergradient
FEEDS = {
    **dict.fromkeys(("y", "y_s"), lambda kind: kind.startswith("(('h'")),
    **dict.fromkeys(("z", "z_s"), lambda kind: kind == "('g', 1)"),
    **dict.fromkeys(("x", "s_x", "u"), lambda kind: kind.endswith(", 0)")),
}


def steps(got, want) -> float:
    """max |got - want| in bf16 steps of want's largest magnitude (0 where
    both are zero); integer and boolean tensors: 0 if equal, else inf."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if not want.is_floating_point():
        return 0.0 if torch.equal(got, want) else float("inf")
    if not want.numel():
        return 0.0
    diff = torch.where(got == want, 0.0, (got.float() - want.float()).abs())  # equal infinities agree
    finite = want.float().abs()
    scale = float(torch.where(torch.isfinite(finite), finite, 0.0).max())
    err = float(diff.max())
    return err / (STEP * scale) if scale else (0.0 if err == 0.0 else float("inf"))


def discrete(value) -> list:
    """The integer and boolean tensors of a node's value (a sort's indices)."""
    vals = value if isinstance(value, (tuple, list)) else [value]
    return [v for v in vals if isinstance(v, torch.Tensor) and not v.is_floating_point()]


def to(obj, dev):
    """Tensors of ``obj`` (through lists, tuples and dicts) on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, (list, tuple)):
        return type(obj)(to(v, dev) for v in obj)
    if isinstance(obj, dict):
        return {k: to(v, dev) for k, v in obj.items()}
    if isinstance(obj, torch.device):
        return torch.device(dev)
    return obj


class Calls:
    """Within the block, every oracle call of ``graphs`` and every dense mix
    is kept with its inputs and outputs, in order."""

    def __init__(self, graphs: OracleGraphs):
        self.graphs, self.oracles, self.mixes = graphs, [], []

    def __enter__(self):
        call, mix = self.graphs._call, C.mix_delta_dense
        self._saved = call, mix

        def recording_call(kind, flat, inv, var):
            outs = call(kind, flat, inv, var)
            self.oracles.append((kind, flat, [t.clone() for t in inv], [t.clone() for t in var],
                                 [t.clone() for t in outs]))
            return outs

        def recording_mix(W, x):
            out = mix(W, x)
            self.mixes.append((W.clone(), tree_map(torch.clone, x), tree_map(torch.clone, out)))
            return out

        self.graphs._call = recording_call
        C.mix_delta_dense = IL.mix_delta_dense = recording_mix
        return self

    def __exit__(self, *exc):
        self.graphs._call = self._saved[0]
        C.mix_delta_dense = IL.mix_delta_dense = self._saved[1]


def round_fields(st) -> dict:
    return dict(x=st.x, s_x=st.s_x, u=st.u_prev, y=st.inner_y.d, y_s=st.inner_y.s, z=st.inner_z.d, z_s=st.inner_z.s)


def source_line(node) -> str:
    """The last frame of the port's model code in a node's stack trace."""
    lines = [ln.strip() for ln in (node.meta.get("stack_trace") or "").splitlines()]
    frames = [ln for ln in lines if ln.startswith("File") and "repro_torch" in ln]
    if not frames:
        return ""
    i = lines.index(frames[-1])
    where = frames[-1].split("repro_torch/")[-1].replace('", line ', ":").split(",")[0]
    return f"{where}: {lines[i + 1] if i + 1 < len(lines) else ''}"


def op_name(node) -> str:
    return getattr(node.target, "__name__", str(node.target))


def gradient_graph(flat, inv, var) -> torch.fx.GraphModule:
    """The oracle's whole gradient graph, traced on the host as the oracles'
    graphs are (the seed rewritten, dead code gone)."""
    kw = {"record_stack_traces": True} if "record_stack_traces" in inspect.signature(
        torch.fx.experimental.proxy_tensor.make_fx).parameters else {}
    gm = torch.fx.experimental.proxy_tensor.make_fx(flat, **kw)(*inv, *var)
    _seed_without_loss(gm)
    return gm


def flips(gm, env: dict, host: dict) -> dict:
    """The nodes whose integer or boolean outputs (a sort's indices: the
    MoE's routing) differ from the host's, with the count of differing
    elements."""
    out = {}
    for node in gm.graph.nodes:
        if node.op == "call_function" and node.target is not operator.getitem:
            n = sum(int((a != b).sum()) for a, b in zip(discrete(env[node]), discrete(host[node])))
            if n:
                out[f"{node.name} ({op_name(node)})"] = n
    return out


def sort_margins(gm, host: dict, k: int) -> dict:
    """Every sort node's rows (the MoE router's probabilities, sorted
    descending): the smallest gap between the k-th and (k+1)-th values
    relative to the k-th, and the rows whose gap is below one bf16 step of
    it (2^-8): near-ties of the top-k routing."""
    out = {}
    for node in gm.graph.nodes:
        if node.op == "call_function" and op_name(node).startswith("sort") and k:
            vals = host[node][0].float()
            if vals.shape[-1] <= k:
                continue
            gap = (vals[..., k - 1] - vals[..., k]).abs() / vals[..., k - 1].abs().clamp_min(1e-30)
            out[node.name] = dict(rows=int(gap.numel()), min_rel_gap=float(gap.min()),
                                  below_a_step=int((gap < STEP).sum()), ties=int((gap == 0).sum()))
    return out


def run_graph(gm, inputs: list, card: str, on_card=lambda node: False):
    """Run ``gm`` node by node on the host's ``inputs``, each node for which
    ``on_card(node)`` holds on ``card`` (its inputs moved there, its output
    moved back).  Returns every node's value."""
    env = {}
    it = iter(inputs)
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = next(it)
        elif node.op == "get_attr":
            env[node] = getattr(gm, node.target)
        elif node.op == "call_function":
            args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), lambda n: env[n])
            if node.target is operator.getitem or not on_card(node):
                env[node] = node.target(*args, **kwargs)
            else:
                env[node] = to(node.target(*to(args, card), **to(kwargs, card)), "cpu")
        elif node.op == "output":
            env[node] = torch.fx.node.map_arg(node.args[0], lambda n: env[n])
    return env


def local_distances(gm, host: dict, card: str) -> list[dict]:
    """Every call node run on the card on the host's values of its inputs,
    its output against the host's."""
    rows = []
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), lambda n: host[n])
        got = node.target(*to(args, card), **to(kwargs, card))
        want = host[node]
        pairs = list(zip(got, want)) if isinstance(want, (tuple, list)) else [(got, want)]
        d = max((steps(g, w) for g, w in pairs if isinstance(w, torch.Tensor)), default=0.0)
        out = want[0] if isinstance(want, (tuple, list)) else want
        ins = [f"{str(a.dtype).removeprefix('torch.')}{list(a.shape)}" for a in node.all_input_nodes
               if isinstance(host.get(a), torch.Tensor) for a in [host[a]]]
        rows.append(dict(node=node.name, op=op_name(node), steps=d,
                         shape=list(out.shape) if isinstance(out, torch.Tensor) else None,
                         dtype=str(out.dtype).removeprefix("torch.") if isinstance(out, torch.Tensor) else None,
                         inputs=ins, source=source_line(node)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="jamba-1.5-large-398b")
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=1, help="repeats of the smoke config's pattern")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--field", default=None, choices=sorted(FEEDS),
                    help="the field whose oracle is traced node by node (default: the one that parts most)")
    ap.add_argument("--device", default="cuda", help="the card (cpu: a rehearsal against the host itself)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = args.device
    if card != "cpu" and not torch.cuda.is_available():
        print("trace_parting: no CUDA device available", file=sys.stderr)
        return 1
    if card != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[env] torch {torch.__version__}; {chip_smoke.nvidia_smi()}")
    base = get_config(args.arch, smoke=True)
    cfg = dataclasses.replace(base, num_layers=args.repeats * len(base.pattern))
    ccfg = chip_smoke.lm_c2dfb("kernel_topk", K=2, ratio=0.1, block=512)
    (hp, hx, hy), (cp, _, _) = (chip_smoke.lm_problem(cfg, args.m, 2, 32, d) for d in ("cpu", card))
    topo = ring(args.m)
    state = C.init_state(hp, ccfg, hx, hy)
    print(f"[trace] {cfg.name}, {cfg.num_layers} layers ({args.repeats} of {base.pattern}), m {args.m}, "
          f"{args.rounds} rounds; card {card}")
    report: dict = {"config": dict(arch=cfg.name, layers=cfg.num_layers, m=args.m, rounds=args.rounds), "rounds": []}
    worst = None
    for t in range(args.rounds):
        log = []
        with selection.recorded(log), Calls(hp.graphs) as hcalls:
            want, _ = C.c2dfb_round(state, None, hp, topo, ccfg)
        with selection.imposed([(r.to(card), k.to(card)) for r, k in log]), Calls(cp.graphs) as ccalls:
            got, _ = C.c2dfb_round(chip_smoke._to(state, card), None, cp, topo, ccfg)
        grads = dict(y_s=want.inner_y.g_prev, z_s=want.inner_z.g_prev)
        fields = {}
        for name, g in round_fields(got).items():
            w = round_fields(want)[name]
            worst_leaf = 0.0
            for a, b, s in zip(tree_leaves(g), tree_leaves(w), tree_leaves(grads.get(name, w))):
                scale = max(float(b.float().abs().max()), float(s.float().abs().max()))
                err = float((a.cpu().float() - b.float()).abs().max())
                worst_leaf = max(worst_leaf, err / (STEP * scale) if scale else 0.0)
            fields[name] = worst_leaf
        print(f"[round {t}] card against host, bf16 steps of each field's scale: "
              + ", ".join(f"{k} {v:.2f}" for k, v in fields.items()))
        # 2. each oracle call and mix on the card, on the host's inputs
        assert [k for k, *_ in hcalls.oracles] == [k for k, *_ in ccalls.oracles], "the rounds called other oracles"
        oracles = []
        for i, ((kind, _, inv, var, outs), (_, cflat, *_)) in enumerate(zip(hcalls.oracles, ccalls.oracles)):
            res = cp.graphs._call(kind, cflat, to(inv, card), to(var, card))
            oracles.append(dict(call=i, kind=str(kind), steps=[steps(r, o) for r, o in zip(res, outs)]))
        mixes = [max(steps(a, b) for a, b in zip(tree_leaves(mix_delta_dense(W.to(card), to(v, card))),
                                                 tree_leaves(out)))
                 for W, v, out in hcalls.mixes]
        by_kind = collections.defaultdict(float)
        for o in oracles:
            by_kind[o["kind"]] = max(by_kind[o["kind"]], max(o["steps"]))
        print(f"[round {t}] {len(oracles)} oracle calls on the card on the host's inputs, the largest distance by "
              f"kind (steps of each output's scale): {dict(by_kind)}; {len(mixes)} mixes, the largest "
              f"{max(mixes, default=0.0):.3f}")
        report["rounds"].append(dict(fields=fields, oracles=oracles, mixes=mixes))
        # the field that parts most (or --field), and the worst call of the oracle that feeds it
        field = args.field or max(fields, key=fields.get)
        if worst is None or fields[field] > worst[0]:
            feeds = [o for o in oracles if FEEDS[field](o["kind"])]
            top = max(feeds, key=lambda o: max(o["steps"]))
            worst = (fields[field], field, max(top["steps"]), t, top["call"], hcalls.oracles[top["call"]])
        state = want

    # 3. the oracle call that feeds the field that parts most, node by node
    parted, field, d, t, i, (kind, flat, inv, var, outs) = worst
    print(f"[trace] traced field: {field}, {parted:.3f} steps in round {t}")
    gm = gradient_graph(flat, inv, var)
    host = run_graph(gm, inv + var, card)
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    check = [steps(a, b) for a, b in zip(host[out_node], outs)]
    print(f"[graph] round {t} call {i} ({kind}): {d:.3f} steps on the card; its graph has "
          f"{sum(n.op == 'call_function' for n in gm.graph.nodes)} operator nodes and gives the oracle's output "
          f"on the host within {max(check):.3g} steps")
    rows = local_distances(gm, host, card)
    print(f"[graph] the {args.top} nodes that differ most on the card given the host's inputs:")
    for r in sorted(rows, key=lambda r: -r["steps"])[:args.top]:
        print(f"[graph]   {r['steps']:10.3f}  {r['node']:24s} {r['op']:28s} {r['dtype']!s:9s} {r['shape']!s:20s} "
              f"<- {', '.join(r['inputs'])[:90]}  {r['source'][:80]}")
    ops = collections.defaultdict(lambda: [0, 0, 0.0])
    for r in rows:
        ops[r["op"]][0] += 1
        ops[r["op"]][1] += r["steps"] > 0
        ops[r["op"]][2] = max(ops[r["op"]][2], r["steps"])
    print("[graph] by operator: nodes, nodes that differ, the largest distance: "
          + ", ".join(f"{k} {n}/{nd}/{mx:.3f}" for k, (n, nd, mx) in sorted(ops.items(), key=lambda kv: -kv[1][2])))

    # 4. each differing operator alone on the card, and the whole graph on the card
    chains, flipped = {}, {}
    for name in [k for k, (_, nd, _) in ops.items() if nd] + ["<all>"]:
        env = run_graph(gm, inv + var, card, lambda n, name=name: name == "<all>" or op_name(n) == name)
        chains[name] = [steps(a, b) for a, b in zip(env[out_node], host[out_node])]
        flipped[name] = flips(gm, env, host)
    print("[chain] the oracle's output (steps of each output's scale) with only this operator on the card: "
          + ", ".join(f"{k} {max(v):.3f}" for k, v in sorted(chains.items(), key=lambda kv: -max(kv[1]))))
    print(f"[chain] integer outputs that differ from the host's (a routing that flips), by chain: {flipped}")
    margins = sort_margins(gm, host, cfg.num_experts_per_tok if cfg.num_experts else 0)
    print(f"[chain] the top-{cfg.num_experts_per_tok} routing's margins on the host (sort nodes): {margins}")
    report["graph"] = dict(field=field, field_steps=parted, round=t, call=i, kind=str(kind), steps=d, nodes=rows,
                           by_op={k: v for k, v in ops.items()}, chains=chains, flips=flipped, margins=margins)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "trace_parting.json").write_text(json.dumps(report, default=str))
    print("[trace] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
