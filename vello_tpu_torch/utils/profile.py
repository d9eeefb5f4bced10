"""In-frame per-stage device profiling (counterpart of
``vello_tpu/utils/profile.py``).

The pipeline's stages run inside ranges named as the JAX package's scopes
(``s01_tile_alloc`` ... ``s10_composite``, ``s19_rank_bounds`` ...
``s22_op_pop``), opened by ``stage``. One ``torch.profiler`` trace of the
real frame links each device kernel to the CPU op that launched it (the
port's own kernels, launched through ctypes, run inside an op-level range
``vt_<name>`` while a profiler records, ``ops/kernels._launch``); the
kernel's time goes to the innermost stage range that holds that op.
Device time linked to no stage is ``_other``.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict

import torch

STAGE_RE = re.compile(r"^s\d\d[a-z]?_\w+$")

_OFF = contextlib.nullcontext()


def stage(name: str):
    """The profiler range of one pipeline stage; a shared no-op context
    when no profiler is recording, so a frame pays one flag test per
    stage."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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


def profile_stages(frame, iters: int = 3, detail: bool = False):
    """Run ``frame()`` once in a profiler's warm-up step (traced and
    dropped: a trace can lose the first kernels it sees), then ``iters``
    times in its recorded step; return {stage: device ms per frame} plus
    "_total" and "_other", or {} when the trace holds no device time (a
    CPU frame). ``detail`` also returns the {(stage, kernel name): ms}
    split and its {(stage, kernel name): device events} counts."""
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
    per, total, counts = stage_kernel_ms(
        prof.profiler.kineto_results.events(), iters)
    if total == 0.0:
        return ({}, {}, {}) if detail else {}
    stages = defaultdict(float)
    for (name, _), ms in per.items():
        stages[name] += ms
    out = {k: stages[k] for k in sorted(stages) if k != "_other"}
    out["_other"] = stages["_other"]
    out["_total"] = total
    return (out, per, counts) if detail else out
