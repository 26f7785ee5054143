"""The traced window: ``torch.profiler`` (CUPTI) over whole rounds, read
from its raw activity records.

``busy_s`` is the union of the device activities' intervals (kernels,
memcpys, memsets), so overlapping activities count once; the window is the
host's wall clock from the first traced round's call to the synchronise
after the last.  An idle gap is named by the host operator that launched
the activity ending it: the innermost ``aten::`` operator around the
launch call with the activity's correlation id.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    rounds: int
    window_s: float
    device: list  # (name, start_ns, end_ns, correlation id)
    host: list  # (name, start_ns, end_ns, correlation id, thread)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> list:
        out = []
        for _, a, b, _ in sorted(self.device, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def device_ops(self, top: int = 10) -> list:
        total = collections.Counter()
        for name, a, b, _ in self.device:
            total[name[:NAME_CHARS]] += (b - a) / 1e9
        return [[n, s] for n, s in total.most_common(top)]

    def idle_gaps(self, top: int = 10, named: int = 500) -> list:
        """Idle seconds between device activities, summed by the host
        operator that launched the activity ending each gap; the
        ``named`` longest gaps are named, the rest summed as one."""
        busy = self.busy_intervals()
        corr_at = {}
        for _, a, _, corr in self.device:
            corr_at.setdefault(a, corr)
        gaps = sorted(((b2[0] - b1[1], b2[0]) for b1, b2 in zip(busy, busy[1:]) if b2[0] > b1[1]), reverse=True)
        launches = {corr: (a, tid) for name, a, _, corr, tid in self.host if corr and not name.startswith("aten::")}
        ops = collections.defaultdict(list)
        for name, a, b, _, tid in self.host:
            if name.startswith("aten::"):
                ops[tid].append((a, b, name))
        for v in ops.values():
            v.sort()
        starts = {tid: [o[0] for o in v] for tid, v in ops.items()}
        total = collections.Counter()
        for i, (gap, end) in enumerate(gaps):
            total[self._launcher(corr_at.get(end), launches, ops, starts) if i < named
                  else "(shorter gaps, not named)"] += gap / 1e9
        return [[n, s] for n, s in total.most_common(top)]

    @staticmethod
    def _launcher(corr, launches, ops, starts) -> str:
        if corr not in launches:
            return "(no launch found)"
        t, tid = launches[corr]
        seq = ops.get(tid, [])
        j = bisect.bisect_right(starts.get(tid, []), t) - 1
        for k in range(j, max(j - 5000, -1), -1):
            if seq[k][1] >= t:
                return seq[k][2][:NAME_CHARS]
        return "(outside any aten op)"


def profile_rounds(step, rounds: int, device: torch.device) -> Trace:
    """Run ``step()`` ``rounds`` times under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        if cuda:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        rec = (e.name(), start, start + e.duration_ns(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            dev.append(rec)
        elif e.device_type() == DeviceType.CPU:
            host.append((*rec, e.start_thread_id()))
    return Trace(rounds=rounds, window_s=wall, device=dev, host=host)
