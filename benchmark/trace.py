"""Reading the traced part of a run's window: one ``torch.profiler``
trace of a block of frames, reduced to what the per-layer readers need.

Device time is linked to the program's stage ranges as the port's
``utils/profile.py`` links it (a frozen copy of its rule): a device event
belongs to the innermost range named like a stage (``s01_tile_alloc`` ...
``s22_op_pop``) that holds, on the launching thread, the start of the CPU
op that launched it (``linked_correlation_id``; where two ops carry that
id, the innermost one holding the runtime call). The benchmark's own host
spans (``bench.*``) tell what the host was doing in each idle gap."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

STAGE_RE = re.compile(r"^s\d\d[a-z]?_\w+$")
SPAN_PREFIX = "bench."
OUTSIDE = "outside_the_benchmark_s_spans"


def _annotation(e) -> bool:
    is_ann = getattr(e, "is_user_annotation", None)
    return bool(is_ann()) if is_ann is not None else False


def _span(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def _launcher(dev, ops, calls):
    cands = ops.get(dev.linked_correlation_id(), ())
    if len(cands) == 1:
        return cands[0]
    call = calls.get((dev.correlation_id(), dev.linked_correlation_id()))
    if call is None:
        return None
    t = call.start_ns()
    inside = [e for e in cands if _span(e)[0] <= t <= _span(e)[1]]
    return max(inside, key=lambda e: e.start_ns()) if inside else None


def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclass
class Trace:
    """What one traced block of ``frames`` frames holds. Times in ns."""

    frames: int
    window: tuple = (0, 0)
    # (stage or "_other", device event name) -> [summed ns, events]
    device: dict = field(default_factory=dict)
    busy_ns: int = 0
    # host span name -> summed ns of the device's idle gaps inside it
    idle_gaps: dict = field(default_factory=dict)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def stage_ms(self, prefixes) -> float:
        """Device ms per frame under the stages whose names start with
        one of ``prefixes``."""
        ns = sum(v[0] for (st, _), v in self.device.items()
                 if st.startswith(tuple(prefixes)))
        return ns / 1e6 / self.frames

    def by_name(self) -> dict:
        """{device event name: [summed ns, events]} over all stages."""
        out = defaultdict(lambda: [0, 0])
        for (_, name), (ns, n) in self.device.items():
            out[name][0] += ns
            out[name][1] += n
        return dict(out)


def read(events, frames: int) -> Trace:
    """Reduce a trace's raw kineto events (``prof.profiler.kineto_results
    .events()``) of ``frames`` frame calls, each inside a host span named
    ``frame_span``. Its window runs from the first of the benchmark's
    host spans to the end of the last span or device operation, or, in a
    trace of the device alone, from its first operation to its last."""
    cpu = torch.autograd.DeviceType.CPU
    dev, ops, calls = [], defaultdict(list), {}
    stages = defaultdict(list)
    spans = []
    for e in events:
        name = e.name()
        staged = STAGE_RE.match(name) is not None
        if e.device_type() != cpu:
            if not staged and not _annotation(e):
                dev.append(e)
        elif name.startswith(SPAN_PREFIX):
            spans.append(_span(e) + (name,))
        elif staged:
            stages[e.start_thread_id()].append(_span(e) + (name,))
        elif e.linked_correlation_id() > 0:
            calls[(e.correlation_id(), e.linked_correlation_id())] = e
        else:
            if not e.is_async():
                ops[e.correlation_id()].append(e)
    tr = Trace(frames=frames)
    per = defaultdict(lambda: [0, 0])
    for d in dev:
        op = _launcher(d, ops, calls)
        held = [] if op is None else [
            r for r in stages[op.start_thread_id()]
            if r[0] <= op.start_ns() <= r[1]]
        acc = per[(max(held)[2] if held else "_other", d.name())]
        acc[0] += d.duration_ns()
        acc[1] += 1
    tr.device = dict(per)
    busy = _union(_span(d) for d in dev)
    if spans:
        start = min(s for s, _, _ in spans)
        end = max([e for _, e, _ in spans] + [e for _, e in busy])
    elif busy:
        # a trace of the device alone: from its first operation to its
        # last (the block starts and ends on a synchronised device)
        start, end = busy[0][0], busy[-1][1]
    else:
        return tr
    tr.window = (start, end)
    tr.busy_ns = sum(min(e, end) - max(s, start) for s, e in busy
                     if e > start and s < end)
    gaps, t = [], start
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        gaps.append((t, end))
    inner = sorted(spans, key=lambda r: r[0] - r[1])   # longest first
    idle = defaultdict(int)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        owner = OUTSIDE
        for s, e, name in reversed(inner):            # innermost first
            if s <= mid <= e:
                owner = name
                break
        idle[owner] += g1 - g0
    tr.idle_gaps = dict(idle)
    return tr
