"""The port's in-frame stage profiling (``vello_tpu_torch.utils.profile``,
``Renderer.profile``) against the JAX package's: the stage ranges of a
frame carry the JAX package's scope names in its order, ``profile`` exists
and returns {} where there is no device trace, and device kernel time is
summed under the nearest stage range above the op that launched it."""

import os
import re

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.pipeline import layered
from vello_tpu_torch.scenes.test_scenes import filled_mmark, layered_mmark
from vello_tpu_torch.utils.profile import (STAGE_RE, profile_stages, stage,
                                           stage_kernel_ms)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


def _jax_scopes(rel):
    """The JAX package's stage scope names in source order (first use)."""
    with open(os.path.join(REPO, rel)) as f:
        names = re.findall(r'named_scope\("(s\d\d[a-z]?_\w+)"\)', f.read())
    return list(dict.fromkeys(names))


def _stage_sequence(frame):
    """The stage ranges a CPU frame opens, in time order, with repeats of
    one range collapsed."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        frame()
    evs = sorted((e for e in prof.events() if STAGE_RE.match(e.name)),
                 key=lambda e: e.time_range.start)
    seq = []
    for e in evs:
        if not seq or seq[-1] != e.name:
            seq.append(e.name)
    return seq


def _frame(scene, aa, speed=False):
    r = Renderer(device="cpu")
    r.render_u8(scene, RenderParams(SIZE, SIZE, antialiasing=aa,
                                    render_mode="speed" if speed
                                    else "quality"))
    return r.frame_thunk()


FLAT = _jax_scopes("vello_tpu/pipeline/render.py")
LAYER_OPS = _jax_scopes("vello_tpu/pipeline/layered.py")


def test_jax_scopes_are_the_expected_ones():
    assert FLAT == ["s01_tile_alloc", "s02_flatten", "s03_touch_expand",
                    "s04_coarse_sort", "s05_segment_starts", "s06_coverage",
                    "s07_fragment_sort", "s08_coverage_assembly",
                    "s09_paint", "s09b_occlusion", "s10_composite"]
    assert LAYER_OPS == ["s19_rank_bounds", "s20_op_draws", "s21_op_push",
                         "s22_op_pop"]


@pytest.mark.parametrize("aa", ["msaa16", "area"])
def test_flat_frame_ranges_in_jax_order(aa):
    assert _stage_sequence(_frame(filled_mmark(1, float(SIZE)), aa)) == FLAT


@pytest.mark.parametrize("mode", ["unfused", "speed"])
def test_unfused_and_speed_frame_ranges_in_jax_order(monkeypatch, mode):
    """The unfused geometry path opens the same ranges (the tag scan,
    decode and flatten under s02, the touch expansion under s03), and so
    does a speed frame."""
    if mode == "unfused":
        monkeypatch.setenv("VELLO_TPU_NO_FUSED_GEOM", "1")
    assert _stage_sequence(_frame(filled_mmark(1, float(SIZE)), "msaa16",
                                  mode == "speed")) == FLAT


def test_layered_frame_ranges_in_jax_order():
    """A layered frame: the fragment stages up to s09, then s19 and one
    range per op of the plan, in the plan's order (pad rows open none)."""
    params = RenderParams(SIZE, SIZE, antialiasing="msaa16")
    rs = resolve(layered_mmark(1, float(SIZE)).encoding, params)
    r = Renderer(device="cpu")
    r.render_resolved(rs, params, out="rgba8")
    assert r.last_profile["layered"]
    seq = _stage_sequence(r.frame_thunk())
    assert seq[:10] == FLAT[:9] + LAYER_OPS[:1]
    names = dict(zip((layered.OP_DRAWS, layered.OP_PUSH, layered.OP_POP),
                     LAYER_OPS[1:]))
    ops = [names[int(k)]
           for k in layered.build_layer_plan(rs)[1]["op_tab"][:, 0]
           if int(k) != layered.OP_NOP]
    assert seq[10:] == [n for j, n in enumerate(ops)
                        if j == 0 or ops[j - 1] != n]
    assert set(LAYER_OPS[1:]) <= set(seq)


def test_stage_is_a_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert stage("s02_flatten") is stage("s03_touch_expand")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage("s02_flatten"):
            torch.ones(3).sum()
    assert any(e.name == "s02_flatten" for e in prof.events())


@pytest.mark.parametrize("aa", ["msaa16", "area"])
def test_renderer_profile_is_empty_on_the_cpu(aa):
    """The JAX package's contract: {} when there is no device trace; the
    method exists (it raised AttributeError before) and leaves the stages
    and the tier in last_profile."""
    params = RenderParams(SIZE, SIZE, antialiasing=aa)
    r = Renderer(device="cpu")
    assert r.profile(filled_mmark(1, float(SIZE)), params) == {}
    assert r.last_profile["stages"] == {}
    assert set(r.last_profile["tier"]) >= {"lines", "touches",
                                           "path_tiles"}


def test_profile_stages_runs_one_warm_up_frame_then_iters():
    """The frame runs once in the profiler's warm-up step and ``iters``
    times in its recorded step."""
    calls = []

    def frame():
        calls.append(1)
        with stage("s02_flatten"):
            torch.ones(8).cumsum(0)

    assert profile_stages(frame, iters=4) == {}
    assert len(calls) == 5


def test_profile_stages_of_a_cpu_frame_is_empty():
    assert profile_stages(_frame(filled_mmark(1, float(SIZE)),
                                 "msaa16")) == {}


class _Raw:
    """A raw kineto event as the profiler records it (what
    ``stage_kernel_ms`` reads), times in us."""

    def __init__(self, cid, name, start, end, device=DeviceType.CPU,
                 linked=0, thread=0):
        self._v = (cid, name, start, end, device, linked, thread)

    def correlation_id(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int((self._v[3] - self._v[2]) * 1000)

    def device_type(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_async(self):
        return False

    def is_user_annotation(self):
        return STAGE_RE.match(self._v[1]) is not None


def _kernels(spec):
    """Device events and their runtime calls from (name, duration,
    launching op or None, the call's time)."""
    dev, calls = [], []
    for j, (name, dur, op, t) in enumerate(spec):
        linked = op.correlation_id() if op is not None else 0
        dev.append(_Raw(100 + j, name, 300, 300 + dur, DeviceType.CUDA,
                        linked))
        if op is not None:
            calls.append(_Raw(100 + j, "cudaLaunchKernel", t, t + 1,
                              linked=linked))
    return dev, calls


def test_kernel_time_goes_to_the_nearest_stage_above_its_op():
    """Synthetic raw events as the profiler records them: each device
    event names the op that launched it (``linked_correlation_id``) and
    shares its own id with the runtime call inside that op. A kernel
    launched by an aten op inside s02, one by the op-level range of a
    ctypes launch inside s02, one by an op inside s03, one by an op
    outside every range, one linked to no op, and the s02 range's own
    device span (kineto's GPU user annotation). Two more CPU events carry
    the ctypes launch's op id, as kineto's own events can: one outside
    every range and one inside s03. Every device event counts once, under
    the stage that holds the op whose span holds its runtime call; the
    span not at all."""
    s02 = _Raw(1, "s02_flatten", 0, 100)
    cum = _Raw(2, "aten::cumsum", 10, 20)
    vt = _Raw(3, "vt_flatten", 30, 40)
    buffer = _Raw(3, "Activity Buffer Request", 1, 2, thread=7)
    s03 = _Raw(4, "s03_touch_expand", 100, 200)
    et = _Raw(5, "vt_expand_touches", 110, 120)
    again = _Raw(3, "aten::empty", 150, 160)
    lone = _Raw(6, "aten::copy_", 200.5, 210)
    dev, calls = _kernels([("cumsum_kernel", 4.0, cum, 12),
                           ("flatten_kernel", 10.0, vt, 33),
                           ("expand_touches_kernel", 6.0, et, 115),
                           ("copy_kernel", 2.0, lone, 205),
                           ("unlinked_kernel", 8.0, None, None),
                           ("s02_flatten", 50.0, s02, 0)])
    per, total, n = stage_kernel_ms([buffer, s02, cum, vt, s03, et, again,
                                     lone]
                                 + calls + dev, iters=2)
    assert total == pytest.approx(30.0 / 1e3 / 2)
    assert per == pytest.approx({
        ("s02_flatten", "cumsum_kernel"): 0.002,
        ("s02_flatten", "flatten_kernel"): 0.005,
        ("s03_touch_expand", "expand_touches_kernel"): 0.003,
        ("_other", "copy_kernel"): 0.001,
        ("_other", "unlinked_kernel"): 0.004})
    assert n == {k: 1 for k in per}


def test_kernel_time_goes_to_the_innermost_stage_on_the_ops_thread():
    """Stage ranges nest (a layered frame's op stages inside a longer
    range) and other threads open ranges at the same time: a kernel goes
    to the innermost range on its op's thread that holds the op."""
    outer = _Raw(1, "s09_paint", 0, 1000)
    inner = _Raw(2, "s20_op_draws", 100, 200)
    other = _Raw(3, "s22_op_pop", 120, 180, thread=9)
    vt = _Raw(4, "vt_composite_over", 130, 140)
    late = _Raw(5, "aten::add", 500, 510)
    dev, calls = _kernels([("composite_over_kernel", 3.0, vt, 131),
                           ("add_kernel", 1.0, late, 501)])
    per, _, _ = stage_kernel_ms([outer, inner, other, vt, late] + calls + dev,
                             iters=1)
    assert per == pytest.approx({("s20_op_draws", "composite_over_kernel"):
                                 0.003, ("s09_paint", "add_kernel"): 0.001})


def test_an_ambiguous_launch_is_linked_to_no_op():
    """Two ops carry the id a kernel names and neither span holds its
    runtime call (or there is no runtime call): the kernel's time goes to
    no stage rather than to a guess, under its own name."""
    s02 = _Raw(1, "s02_flatten", 0, 100)
    vt = _Raw(3, "vt_flatten", 30, 40)
    s03 = _Raw(4, "s03_touch_expand", 100, 200)
    again = _Raw(3, "aten::empty", 150, 160)
    k1 = _Raw(100, "flatten_kernel", 300, 310, DeviceType.CUDA, 3)
    k2 = _Raw(101, "flatten_kernel", 320, 326, DeviceType.CUDA, 3)
    call = _Raw(100, "cudaLaunchKernel", 60, 61, linked=3)
    per, total, _ = stage_kernel_ms([s02, vt, s03, again, call, k1, k2],
                                 iters=1)
    assert total == pytest.approx(0.016)
    assert per == pytest.approx({("_other", "flatten_kernel"): 0.016})


def test_the_innermost_op_holding_the_call_launched_it():
    """An event that carries the op's id and whose span also holds the
    runtime call (a kineto event around the launch) does not take the
    kernel from the op inside it."""
    s02 = _Raw(1, "s02_flatten", 0, 100)
    s03 = _Raw(4, "s03_touch_expand", 100, 200)
    wide = _Raw(3, "Activity Buffer Request", 20, 150)
    vt = _Raw(3, "vt_flatten", 30, 40)
    dev, calls = _kernels([("flatten_kernel", 10.0, vt, 33)])
    per, _, _ = stage_kernel_ms([s02, s03, wide, vt] + calls + dev, iters=1)
    assert per == pytest.approx({("s02_flatten", "flatten_kernel"): 0.01})


def test_a_cpu_trace_reads_as_no_device_time():
    """The raw events of a real CPU trace (the stage ranges, aten ops)
    hold no device event: no time, no stage."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stage("s02_flatten"):
            torch.ones(8).cumsum(0)
    per, total, _ = stage_kernel_ms(prof.profiler.kineto_results.events(), 1)
    assert total == 0.0
    assert per == {}


def test_profile_stages_tool_prints_one_json_object(capsys):
    """``python -m vello_tpu_torch.tools.profile_stages [complexity]
    [size]`` (the twin of tools/profile_stages.py): the host encode group,
    then the msaa16, area and msaa16_speed paths, each with its stages
    (empty on the CPU: no device trace) and tier; the last line printed
    is the JSON object it returns."""
    import json

    from vello_tpu_torch.tools import profile_stages
    out = profile_stages.main(["1", str(SIZE)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(out))
    assert set(out) == {"encode", "n_paths", "n_segs", "est_lines", "size",
                        "device", "paths"}
    assert set(out["encode"]) == {"build_s", "encode_streams_s",
                                  "resolve_s"}
    assert all(v > 0.0 for v in out["encode"].values())
    assert out["size"] == SIZE and out["device"] == "cpu"
    assert list(out["paths"]) == ["msaa16", "area", "msaa16_speed"]
    for path in out["paths"].values():
        assert path["stages_ms"] == {} and path["idle"] == {}
        assert {"lines", "touches", "path_tiles"} <= set(path["tier"])
