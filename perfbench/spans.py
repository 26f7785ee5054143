"""Device time by the program's layer, read from the spans the program opens
itself (``repro_torch.obs.timeline.layer``: profiler ranges named
``repro_torch/<layer>``, recorded by the profiler on its own clock).

Each device activity of a traced window is mapped through its correlation id
to the CUDA API call that launched it (a host record whose name begins with
``cu``: ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...),
and from there to the innermost ``repro_torch/`` span open on the launching
thread at the launch.  An activity with no launch
record, or launched outside every span, goes to no span (None).
"""

from __future__ import annotations

import collections
import dataclasses

PREFIX = "repro_torch/"
# the layer spans; oracle_trace (the tracing of an oracle's gradient) lies
# inside an oracle span and counts as the oracle layer's
LAYERS = {name: PREFIX + name for name in ("oracle", "mix", "update", "compress", "meter", "stats")}
ORACLE_TRACE = PREFIX + "oracle_trace"
LAYER_SPANS = frozenset(LAYERS.values()) | {ORACLE_TRACE}
NO_LAUNCH = "(no launch record)"


@dataclasses.dataclass
class Attribution:
    seconds: dict  # innermost span name (None: outside every span, NO_LAUNCH) -> device seconds
    activities: list  # (device activity's name, duration s, innermost span) in the trace's order
    present: set  # span names the trace holds
    total_s: float  # every device activity's seconds


def _launches(trace) -> dict:
    """Correlation id -> (launch time, thread) of each device activity's
    CUDA API call."""
    wanted = {corr for *_, corr in trace.device}
    out = {}
    for name, a, _, corr, tid in trace.host:
        if corr in wanted and name.startswith("cu"):
            out.setdefault(corr, (a, tid))
    return out


def innermost(trace) -> list:
    """For each device activity, in ``trace.device``'s order, the innermost
    span around its launch: a span name, None (launched outside every
    span) or `NO_LAUNCH`."""
    launches = _launches(trace)
    events = collections.defaultdict(list)  # thread -> (time, order, ...)
    for i, (name, a, b, _, tid) in enumerate(trace.host):
        if name.startswith(PREFIX):
            # at one instant: opens (outer first), launches, then closes
            events[tid].append((a, 0, -b, i))
            events[tid].append((b, 2, 0, i))
    out = [NO_LAUNCH] * len(trace.device)
    for j, (*_, corr) in enumerate(trace.device):
        if corr in launches:
            t, tid = launches[corr]
            events[tid].append((t, 1, 0, j))
    for evs in events.values():
        evs.sort()
        stack = []
        for _, order, _, k in evs:
            if order == 0:
                stack.append(k)
            elif order == 2:
                if k in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(k)]
            else:
                out[k] = trace.host[stack[-1]][0] if stack else None
    return out


def attribute(trace) -> Attribution:
    spans = innermost(trace)
    seconds = collections.Counter()
    activities = []
    for (name, a, b, _), span in zip(trace.device, spans):
        seconds[span] += (b - a) / 1e9
        activities.append((name, (b - a) / 1e9, span))
    present = {name for name, *_ in trace.host if name.startswith(PREFIX)}
    return Attribution(dict(seconds), activities, present, sum(seconds.values()))


def of(ctx) -> Attribution:
    """The run's attribution, computed once for all of its readers."""
    att = getattr(ctx, "_span_attribution", None)
    if att is None:
        att = ctx._span_attribution = attribute(ctx.trace)
    return att


def layer_ms(ctx, layer: str) -> float | None:
    """Device ms a round launched inside ``layer``'s spans (the oracle
    layer's with the tracing inside them); None where the trace holds no
    such span or no device activity."""
    att = of(ctx)
    names = {LAYERS[layer]} | ({ORACLE_TRACE} if layer == "oracle" else set())
    if not att.present & names or not ctx.trace.device:
        return None
    return sum(att.seconds.get(n, 0.0) for n in names) * 1e3 / ctx.trace.rounds


def spanned_share(ctx) -> float | None:
    """Device time launched inside a layer span over all device time, in %;
    None where the trace holds no layer span or no device activity."""
    att = of(ctx)
    if not att.present & LAYER_SPANS or att.total_s <= 0:
        return None
    return 100.0 * sum(s for n, s in att.seconds.items() if n in LAYER_SPANS) / att.total_s


def idle_by_span(trace) -> dict:
    """Idle seconds between device activities, summed by the innermost span
    around the launch of the activity that ends each gap."""
    spans = innermost(trace)
    first = {}  # start -> the innermost span of an activity starting there
    for (_, a, _, _), span in zip(trace.device, spans):
        first.setdefault(a, span)
    busy = trace.busy_intervals()
    out = collections.Counter()
    for (_, end), (start, _) in zip(busy, busy[1:]):
        if start > end:
            out[first.get(start)] += (start - end) / 1e9
    return dict(out)
