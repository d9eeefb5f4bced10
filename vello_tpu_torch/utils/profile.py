"""In-frame per-stage device profiling (counterpart of
``vello_tpu/utils/profile.py``), and the host spans of the same frames.

The pipeline's stages run inside ranges named as the JAX package's scopes
(``s01_tile_alloc`` ... ``s10_composite``, ``s19_rank_bounds`` ...
``s22_op_pop``), opened by ``stage``. One ``torch.profiler`` trace of the
real frame links each device kernel to the CPU op that launched it (the
port's own kernels, launched through ctypes, run inside an op-level range
``vt_<name>`` while a profiler records, ``ops/kernels._launch``); the
kernel's time goes to the innermost stage range that holds that op.
Device time linked to no stage is ``_other``.

The host side goes to ``RECORDER``, in memory, on the one switch that
``stage`` already tests (a profiler recording):
- while one records, each stage times its range on
  ``time.perf_counter_ns``, and the frame call that
  ``Renderer.frame_thunk()`` hands out opens ``vt.frame`` (``frame_span``):
  it counts the frame and its host ns and, on a CUDA frame, the host-device
  synchronisations made inside it, each under the innermost open stage.
  With no profiler the frame pays one flag test more, and nothing else;
- set-up phases, once per scene (``Span``: ``vt.resolve.decode``,
  ``vt.resolve.paint``, ``vt.resolve.estimate``, ``vt.upload``,
  ``vt.first_frame`` with its child ``vt.kernels_load``, ``vt.render`` and
  ``vt.readback``), are timed always on ``time.perf_counter``, a clock read
  at each end, and are profiler ranges too while one records.

``idle_by_range`` reduces a trace to the device's idle gaps and the host's
CUDA runtime calls under the innermost of these ranges that the host was
in.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
import warnings
from collections import defaultdict, deque

import torch

STAGE_RE = re.compile(r"^s\d\d[a-z]?_\w+$")
# the program's host ranges: the stages and the ``vt.`` spans
RANGE_PREFIX = "vt."
# CUDA API calls (``cuda*``, ``cu*``), as the profiler names them
RUNTIME_RE = re.compile(r"^cu(da)?[A-Z]\w*$")
FRAME = "vt.frame"
OUTSIDE = "_outside"
# the newest durations kept per set-up span name
SPAN_KEPT = 256
# the text of the warning that torch's sync-debug mode gives, and of the
# one torch gives the first time the mode is set
SYNC_WARNING = "called a synchronizing CUDA operation"
PROTOTYPE_WARNING = "Synchronization debug mode is a prototype"

_OFF = contextlib.nullcontext()


class Recorder:
    """The program's host spans, in memory.

    Per-frame tables, filled only while a profiler records: ``frames`` and
    ``frame_ns`` of ``vt.frame``; ``stage_ns`` (self time: a stage opened
    inside another is taken out of the outer one's) and ``stage_entries``
    per stage name; ``syncs`` per stage name (``vt.frame`` where no stage
    was open) over the ``sync_frames`` CUDA frames counted with the sync
    counter on. Set-up table ``spans``: the newest ``SPAN_KEPT`` durations
    (s) of each ``Span`` name."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.frames = 0
        self.frame_ns = 0
        self.sync_frames = 0
        self.stage_ns = defaultdict(int)
        self.stage_entries = defaultdict(int)
        self.syncs = defaultdict(int)
        self.spans = defaultdict(lambda: deque(maxlen=SPAN_KEPT))
        self.open_stages = []     # [name, start ns, children's ns]
        self.open_spans = []      # the Spans open now, outermost first

    def sync(self) -> None:
        """One host-device synchronisation, under the innermost open
        stage."""
        self.syncs[self.open_stages[-1][0] if self.open_stages
                   else FRAME] += 1

    def add(self, name: str, seconds: float) -> None:
        self.spans[name].append(seconds)

    def last(self, name: str):
        """The newest duration (s) of the set-up span ``name``, or None."""
        kept = self.spans.get(name)
        return kept[-1] if kept else None

    def span_ms(self, name: str):
        """The mean of the kept durations of ``name`` in ms, or None."""
        kept = self.spans.get(name)
        return 1e3 * sum(kept) / len(kept) if kept else None

    def frame_host_ms(self):
        """Host ms of ``vt.frame`` per recorded frame, or None."""
        return self.frame_ns / 1e6 / self.frames if self.frames else None

    def stage_host_ms(self, prefixes):
        """Host self ms per recorded frame of the stages whose names start
        with one of ``prefixes`` (0 where none ran), or None."""
        if not self.frames:
            return None
        ns = sum(v for k, v in self.stage_ns.items()
                 if k.startswith(tuple(prefixes)))
        return ns / 1e6 / self.frames

    def frame_syncs(self):
        """Synchronisations per CUDA frame counted, or None."""
        if not self.sync_frames:
            return None
        return sum(self.syncs.values()) / self.sync_frames


RECORDER = Recorder()


class _Stage:
    """A stage's profiler range, timed into ``RECORDER``."""

    __slots__ = ("_range", "_open")

    def __init__(self, name: str):
        self._range = torch.profiler.record_function(name)
        self._open = [name, 0, 0]

    def __enter__(self):
        self._range.__enter__()
        RECORDER.open_stages.append(self._open)
        self._open[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._open[1]
        opened = RECORDER.open_stages
        opened.pop()
        name = self._open[0]
        RECORDER.stage_ns[name] += ns - self._open[2]
        RECORDER.stage_entries[name] += 1
        if opened:
            opened[-1][2] += ns
        return self._range.__exit__(*exc)


def stage(name: str):
    """The profiler range of one pipeline stage, timed on the host while a
    profiler records; a shared no-op context when none is recording, so a
    frame pays one flag test per stage."""
    if torch.autograd._profiler_enabled():
        return _Stage(name)
    return _OFF


class _SyncCounter:
    """While open, every host-device synchronisation goes to
    ``RECORDER.sync``: torch's sync-debug mode at "warn" flags
    ``.item()``, a tensor's ``int``/``float``/``bool``, ``nonzero``,
    blocking copies and stream synchronisations, and its warnings are
    counted instead of shown (other warnings pass on, but for torch's
    note that the mode is a prototype); ``torch.cuda.synchronize`` counts
    in a wrapper that turns the mode off around it, so that it counts once
    whether or not the mode flags it. The mode, the warning filters and
    ``torch.cuda.synchronize`` are restored on exit, on an exception
    too."""

    def __enter__(self):
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        try:
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.filterwarnings("ignore", message=PROTOTYPE_WARNING)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if str(message).startswith(SYNC_WARNING):
                    RECORDER.sync()
                else:
                    shown(message, category, filename, lineno, file, line)

            warnings.showwarning = show
            self._synchronize = synchronize = torch.cuda.synchronize

            def counted(device=None):
                RECORDER.sync()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    return synchronize(device)
                finally:
                    torch.cuda.set_sync_debug_mode("warn")

            torch.cuda.synchronize = counted
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        except BaseException:
            self._restore()
            raise
        return self

    def _restore(self) -> None:
        try:
            if hasattr(self, "_mode"):
                torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            if hasattr(self, "_synchronize"):
                torch.cuda.synchronize = self._synchronize
            self._warnings.__exit__(None, None, None)

    def __exit__(self, *exc):
        self._restore()
        return False


class _Frame:
    """``vt.frame``: a profiler range around one frame call that counts
    the frame and its host ns, and on a CUDA frame its synchronisations."""

    __slots__ = ("_range", "_sync", "_t0")

    def __init__(self, cuda: bool):
        self._range = torch.profiler.record_function(FRAME)
        self._sync = _SyncCounter() if cuda else None

    def __enter__(self):
        self._range.__enter__()
        if self._sync is not None:
            self._sync.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        try:
            if self._sync is not None:
                self._sync.__exit__(*exc)
                RECORDER.sync_frames += 1
        finally:
            RECORDER.frames += 1
            RECORDER.frame_ns += ns
            self._range.__exit__(*exc)
        return False


def frame_span(cuda: bool):
    """``vt.frame`` around a frame call while a profiler records (``cuda``:
    count the frame's synchronisations too); the shared no-op context
    otherwise."""
    if torch.autograd._profiler_enabled():
        return _Frame(cuda)
    return _OFF


class Span:
    """A set-up phase's host span: its duration (s, ``seconds`` once
    closed) on ``time.perf_counter`` goes to ``RECORDER`` whether or not a
    profiler records, and it is a profiler range while one does.
    ``within(name)`` is the sum of the spans named ``name`` that closed
    while this one was open, at any depth."""

    __slots__ = ("name", "seconds", "_inner", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._inner = {}

    def __enter__(self):
        self._range = (torch.profiler.record_function(self.name)
                       if torch.autograd._profiler_enabled() else None)
        if self._range is not None:
            self._range.__enter__()
        RECORDER.open_spans.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        RECORDER.open_spans.pop()
        RECORDER.add(self.name, self.seconds)
        for outer in RECORDER.open_spans:
            outer._inner[self.name] = (outer._inner.get(self.name, 0.0)
                                       + self.seconds)
        if self._range is not None:
            return self._range.__exit__(*exc)
        return False

    def within(self, name: str) -> float:
        return self._inner.get(name, 0.0)


def _annotation(e) -> bool:
    """A range's own span (kineto's user annotations, on the host and on
    the device): no kernel."""
    is_ann = getattr(e, "is_user_annotation", None)
    return bool(is_ann()) if is_ann is not None else False


def _span(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def _launcher(dev, ops, calls):
    """The CPU op that launched device event ``dev``: the op whose
    correlation id is the event's ``linked_correlation_id``. Two events can
    carry that id (kineto gives some of its own, such as "Activity Buffer
    Request", ids that collide with an op's); then the launcher is the
    innermost of them whose span holds the runtime call
    (``cudaLaunchKernel`` and the like, the CPU event linked to the same
    op with the device event's own correlation id). None when no op is
    found."""
    cands = ops.get(dev.linked_correlation_id(), ())
    if len(cands) == 1:
        return cands[0]
    call = calls.get((dev.correlation_id(), dev.linked_correlation_id()))
    if call is None:
        return None
    t = call.start_ns()
    inside = [e for e in cands if _span(e)[0] <= t <= _span(e)[1]]
    return max(inside, key=lambda e: e.start_ns()) if inside else None


def stage_kernel_ms(events, iters: int):
    """({(stage, kernel name): device ms per frame}, device ms per frame,
    {(stage, kernel name): device events}) from a trace's raw kineto
    events (``profile.profiler.kineto_results
    .events()``) over ``iters`` frames. Each device event counts once, under
    the innermost stage range on the launching op's thread that holds the
    op's start (``_launcher``), or under "_other" when it is outside every
    stage or no launching op is found. The ranges' own device spans do not
    count."""
    cpu = torch.autograd.DeviceType.CPU
    dev, ops, calls = [], defaultdict(list), {}
    stages = defaultdict(list)           # thread -> [(start, end, name)]
    for e in events:
        staged = STAGE_RE.match(e.name()) is not None
        if e.device_type() != cpu:
            if not staged and not _annotation(e):
                dev.append(e)
        elif staged:
            stages[e.start_thread_id()].append(_span(e) + (e.name(),))
        elif e.linked_correlation_id() > 0:
            calls[(e.correlation_id(), e.linked_correlation_id())] = e
        elif not e.is_async():
            ops[e.correlation_id()].append(e)
    per, counts = defaultdict(float), defaultdict(int)
    total = 0.0
    for d in dev:
        ns = d.duration_ns()
        total += ns
        op = _launcher(d, ops, calls)
        held = [] if op is None else [
            r for r in stages[op.start_thread_id()]
            if r[0] <= op.start_ns() <= r[1]]
        key = (max(held)[2] if held else "_other", d.name())
        per[key] += ns
        counts[key] += 1
    scale = 1e6 * iters
    return ({k: v / scale for k, v in per.items()}, total / scale,
            dict(counts))


def _timeline(ranges):
    """The host's innermost open range over time: sorted disjoint
    (start, end, name) segments from -inf to +inf, ``OUTSIDE`` where no
    range is open. A range opened later than another still open is the
    inner one (ranges on one thread nest)."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(ranges)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(ranges)])
    out, stack, t0 = [], [], float("-inf")
    for t, opens, i in marks:
        if t > t0:
            out.append((t0, t, ranges[stack[-1]][2] if stack else OUTSIDE))
            t0 = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    out.append((t0, float("inf"), OUTSIDE))
    return out


def idle_by_range(events, iters: int) -> dict:
    """{range: {"idle_ms", "host_ms", "runtime_ms": {call: ms},
    "runtime_calls": {call: calls}}} per frame, from a trace's raw kineto
    events over ``iters`` frames. A range is one of the program's host
    ranges (the stages and the ``vt.`` spans), or ``OUTSIDE``. Each idle
    gap of the device (no kernel, copy or fill running, between the first
    of these ranges or device events and the last) goes to the innermost
    range the host was in, split where the host moved on; ``host_ms`` is
    each range's self time; each CUDA API call on the host
    (``cudaLaunchKernel``, ``cudaStreamSynchronize``, ``cudaMemcpyAsync``
    ...) counts, whole, under the innermost range at its start. {} when
    the trace holds no device event."""
    cpu = torch.autograd.DeviceType.CPU
    dev, ranges, calls = [], [], []
    for e in events:
        name = e.name()
        program = name.startswith(RANGE_PREFIX) or STAGE_RE.match(name)
        if e.device_type() != cpu:
            if not program and not _annotation(e):
                dev.append(_span(e))
        elif program:
            ranges.append(_span(e) + (name,))
        elif RUNTIME_RE.match(name):
            calls.append(_span(e) + (name,))
    if not dev:
        return {}
    busy = _union(dev)
    start = min([busy[0][0]] + [s for s, _, _ in ranges])
    end = max([busy[-1][1]] + [e for _, e, _ in ranges])
    gaps, t = [], start
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < end:
        gaps.append((t, end))
    line = _timeline(ranges)
    out = defaultdict(lambda: {"idle_ms": 0.0, "host_ms": 0.0,
                               "runtime_ms": defaultdict(float),
                               "runtime_calls": defaultdict(float)})
    scale = 1e6 * iters
    j = 0
    for g0, g1 in gaps:
        while line[j][1] <= g0:
            j += 1
        k = j
        while k < len(line) and line[k][0] < g1:
            s, e, name = line[k]
            out[name]["idle_ms"] += (min(e, g1) - max(s, g0)) / scale
            k += 1
    for s, e, name in line[1:-1]:
        if name != OUTSIDE:
            out[name]["host_ms"] += (e - s) / scale
    starts = [s for s, _, _ in line]
    for s, e, call in calls:
        name = line[bisect.bisect_right(starts, s) - 1][2]
        out[name]["runtime_ms"][call] += (e - s) / scale
        out[name]["runtime_calls"][call] += 1.0 / iters
    return {name: dict(v, runtime_ms=dict(v["runtime_ms"]),
                       runtime_calls=dict(v["runtime_calls"]))
            for name, v in out.items()}


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


def profile_stages(frame, iters: int = 3, detail: bool = False):
    """Run ``frame()`` once in a profiler's warm-up step (traced and
    dropped: a trace can lose the first kernels it sees), then ``iters``
    times in its recorded step; return {stage: device ms per frame} plus
    "_total" and "_other", or {} when the trace holds no device time (a
    CPU frame). ``detail`` also returns the {(stage, kernel name): ms}
    split, its {(stage, kernel name): device events} counts and
    ``idle_by_range`` of the recorded step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for n in (1, iters):
            for _ in range(n):
                frame()
            if cuda:
                torch.cuda.synchronize()
            prof.step()
    events = prof.profiler.kineto_results.events()
    per, total, counts = stage_kernel_ms(events, iters)
    if total == 0.0:
        return ({}, {}, {}, {}) if detail else {}
    stages = defaultdict(float)
    for (name, _), ms in per.items():
        stages[name] += ms
    out = {k: stages[k] for k in sorted(stages) if k != "_other"}
    out["_other"] = stages["_other"]
    out["_total"] = total
    if detail:
        return out, per, counts, idle_by_range(events, iters)
    return out
