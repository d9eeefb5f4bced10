"""The port's host spans (``vello_tpu_torch.utils.profile.RECORDER``): with
no profiler recording, a frame touches nothing of them and turns on no
sync-debug mode; while a CPU profiler records, the recorder counts the
frames called, their stages' self time and the synchronisations made
inside them, each under the stage that made it; the set-up spans of
resolve, upload and the first frame are timed always; ``idle_by_range``
splits the device's idle gaps and the host's runtime calls by range. The
sync-debug mode itself needs a card (``tests/test_torch_cuda.py``)."""

import time
import types
import warnings

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.models.renderer import frame_call
from vello_tpu_torch.scenes.test_scenes import filled_mmark
from vello_tpu_torch.utils import profile as vprof
from vello_tpu_torch.utils.profile import (FRAME, OUTSIDE, RECORDER,
                                           SYNC_WARNING, Span, frame_span,
                                           idle_by_range, stage)

SIZE = 64
PARAMS = RenderParams(SIZE, SIZE, antialiasing="area")
GROUPS = (("s01", "s02", "s03", "s04", "s05"), ("s06", "s07", "s08"),
          ("s09_",), ("s09b", "s10", "s19", "s20", "s21"))


@pytest.fixture(autouse=True)
def fresh_recorder():
    RECORDER.reset()
    yield
    RECORDER.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _per_frame_tables():
    return (RECORDER.frames, RECORDER.frame_ns, RECORDER.sync_frames,
            dict(RECORDER.stage_ns), dict(RECORDER.stage_entries),
            dict(RECORDER.syncs))


def _thunk(seed=0):
    rs = resolve(filled_mmark(1, float(SIZE), seed=seed).encoding, PARAMS)
    r = Renderer(device="cpu")
    r.render_resolved(rs, PARAMS, out="rgba8")
    return r.frame_thunk()


def test_without_a_profiler_frames_and_resolve_leave_no_frame_table():
    """No profiler: a resolve and frames leave the per-frame tables empty
    (the set-up spans are timed always), and stage() and vt.frame are the
    one shared no-op context."""
    assert not torch.autograd._profiler_enabled()
    thunk = _thunk()
    for _ in range(3):
        thunk()
    assert _per_frame_tables() == (0, 0, 0, {}, {}, {})
    assert RECORDER.frame_host_ms() is None and RECORDER.frame_syncs() is None
    assert all(RECORDER.stage_host_ms(g) is None for g in GROUPS)
    assert {"vt.resolve.decode", "vt.resolve.paint", "vt.resolve.estimate",
            "vt.upload", "vt.first_frame", "vt.render",
            "vt.readback"} <= set(RECORDER.spans)
    off = stage("s02_flatten")
    assert off is stage("s10_composite")
    assert frame_span(True) is off and frame_span(False) is off


def test_the_frame_path_off_updates_nothing_and_sets_no_sync_mode(
        monkeypatch):
    """No profiler: the frame closure, even a CUDA one's, reads no clock
    of the recorder, sets no warning filter and no sync-debug mode, wraps
    no ``torch.cuda.synchronize`` and changes no table of the recorder."""
    thunk = _thunk()
    calls = []

    def refuse(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called with no profiler")
        return f

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        refuse("set_sync_debug_mode"))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        refuse("get_sync_debug_mode"))
    monkeypatch.setattr(warnings, "catch_warnings", refuse("catch_warnings"))
    monkeypatch.setattr(vprof, "time", types.SimpleNamespace(
        perf_counter_ns=refuse("perf_counter_ns"),
        perf_counter=refuse("perf_counter")))
    synchronize = torch.cuda.synchronize
    cuda_frame = frame_call(lambda b: thunk(), {}, cuda=True)
    before = _per_frame_tables()
    spans = {k: list(v) for k, v in RECORDER.spans.items()}
    for _ in range(3):
        thunk()
        cuda_frame()
    assert calls == []
    assert torch.cuda.synchronize is synchronize
    assert _per_frame_tables() == before == (0, 0, 0, {}, {}, {})
    assert {k: list(v) for k, v in RECORDER.spans.items()} == spans


@pytest.mark.parametrize("n", [1, 4])
def test_a_profiled_frame_is_counted_once(n):
    """Under a CPU profiler the recorder counts exactly the frames called;
    each flat stage is entered once a frame; the stage groups' self time
    is within the frames' host time; no sync is counted on a CPU frame."""
    thunk = _thunk()
    with _cpu_profile():
        for _ in range(n):
            thunk()
    assert RECORDER.frames == n
    assert RECORDER.frame_ns > 0
    assert set(RECORDER.stage_entries.values()) == {n}
    assert len(RECORDER.stage_entries) == 11
    groups = sum(RECORDER.stage_host_ms(g) for g in GROUPS)
    assert 0 < groups <= RECORDER.frame_host_ms()
    assert RECORDER.sync_frames == 0 and RECORDER.frame_syncs() is None


def test_resolve_phases_lie_within_resolve():
    """The three resolve spans, each recorded once, sum to no more than
    the wall time of the resolve that holds them."""
    scene = filled_mmark(1, float(SIZE))
    t0 = time.perf_counter()
    resolve(scene.encoding, PARAMS)
    wall = time.perf_counter() - t0
    phases = ("vt.resolve.decode", "vt.resolve.paint",
              "vt.resolve.estimate")
    assert [len(RECORDER.spans[p]) for p in phases] == [1, 1, 1]
    assert 0 < sum(RECORDER.last(p) for p in phases) <= wall


def test_upload_and_first_frame_once_per_new_scene():
    """vt.upload and vt.first_frame are recorded once for each resolved
    scene a Renderer renders first, none for a scene it renders again;
    last_profile takes wall_s, readback_s, upload_s, first_frame_s and
    kernels_load_s from the spans (no kernel library on the CPU)."""
    r = Renderer(device="cpu")
    a = resolve(filled_mmark(1, float(SIZE), seed=1).encoding, PARAMS)
    b = resolve(filled_mmark(1, float(SIZE), seed=2).encoding, PARAMS)
    r.render_resolved(a, PARAMS)
    first = dict(r.last_profile)
    r.render_resolved(a, PARAMS)
    again = dict(r.last_profile)
    r.render_resolved(b, PARAMS, out="rgba8")
    assert len(RECORDER.spans["vt.upload"]) == 2
    assert len(RECORDER.spans["vt.first_frame"]) == 2
    assert len(RECORDER.spans["vt.render"]) == 3
    assert len(RECORDER.spans["vt.readback"]) == 3
    assert first["wall_s"] == list(RECORDER.spans["vt.render"])[0]
    assert first["readback_s"] == list(RECORDER.spans["vt.readback"])[0]
    assert 0 < first["upload_s"] < first["wall_s"]
    assert 0 < first["first_frame_s"] < first["wall_s"]
    assert first["upload_s"] + first["first_frame_s"] <= first["wall_s"]
    assert again["upload_s"] == 0.0 and again["first_frame_s"] == 0.0
    assert again["wall_s"] > 0.0
    assert first["kernels_load_s"] == again["kernels_load_s"] == 0.0


def test_a_span_records_its_children():
    with Span("vt.render") as outer:
        with Span("vt.first_frame"):
            with Span("vt.kernels_load"):
                pass
        with Span("vt.first_frame"):
            pass
    kept = list(RECORDER.spans["vt.first_frame"])
    assert outer.within("vt.first_frame") == pytest.approx(sum(kept))
    assert outer.within("vt.kernels_load") == RECORDER.last(
        "vt.kernels_load")
    assert outer.within("vt.upload") == 0.0
    assert outer.seconds == RECORDER.last("vt.render")
    assert RECORDER.open_spans == []


def test_a_stage_counts_its_self_time():
    """A stage opened inside another is taken out of the outer one's
    time."""
    with _cpu_profile():
        with stage("s09_paint"):
            time.sleep(0.002)
            with stage("s20_op_draws"):
                time.sleep(0.02)
    outer, inner = RECORDER.stage_ns["s09_paint"], RECORDER.stage_ns[
        "s20_op_draws"]
    assert inner >= 20e6 and 2e6 <= outer < inner
    assert RECORDER.open_stages == []


def test_a_sync_goes_to_the_innermost_open_stage():
    """The counting path: a sync made in a stage counts under it, one in a
    nested stage under the inner one, one between stages under
    vt.frame."""
    with _cpu_profile():
        with frame_span(False):
            RECORDER.sync()
            with stage("s02_flatten"):
                RECORDER.sync()
                with stage("s03_touch_expand"):
                    RECORDER.sync()
                    RECORDER.sync()
            with stage("s04_coarse_sort"):
                RECORDER.sync()
    assert dict(RECORDER.syncs) == {FRAME: 1, "s02_flatten": 1,
                                    "s03_touch_expand": 2,
                                    "s04_coarse_sort": 1}
    assert RECORDER.frames == 1


@pytest.fixture
def fake_sync_mode(monkeypatch):
    """torch's sync-debug mode and torch.cuda.synchronize as stubs: the
    modes set, in order, and the synchronize calls."""
    got = {"modes": [], "synchronize": 0}

    def set_mode(mode):
        got["modes"].append(mode)

    def synchronize(device=None):
        got["synchronize"] += 1

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    got["stub"] = synchronize
    return got


def test_a_cuda_frame_counts_sync_warnings_and_synchronize(fake_sync_mode):
    """A CUDA frame's sync counter: the mode's warnings count under the
    open stage and are not shown, every one of them (no once-per-place
    filter); torch.cuda.synchronize counts through its wrapper with the
    mode off around it; another warning passes on; the mode and
    synchronize are restored."""
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with _cpu_profile():
            with frame_span(True):
                with stage("s04_coarse_sort"):
                    for _ in range(2):
                        warnings.warn(f"{SYNC_WARNING} (Triggered "
                                      f"internally)", UserWarning)
                    torch.cuda.synchronize()
                with stage("s05_segment_starts"):
                    warnings.warn("something else", UserWarning)
                warnings.warn(SYNC_WARNING, UserWarning)
    assert [str(w.message) for w in shown] == ["something else"]
    assert dict(RECORDER.syncs) == {"s04_coarse_sort": 3, FRAME: 1}
    assert RECORDER.sync_frames == 1 and RECORDER.frame_syncs() == 4.0
    assert fake_sync_mode["synchronize"] == 1
    assert fake_sync_mode["modes"] == ["warn", 0, "warn", 0]
    assert torch.cuda.synchronize is fake_sync_mode["stub"]


def test_a_cuda_frame_restores_the_mode_on_an_exception(fake_sync_mode):
    filters = list(warnings.filters)
    with _cpu_profile():
        with pytest.raises(RuntimeError, match="in the frame"):
            with frame_span(True):
                with stage("s02_flatten"):
                    raise RuntimeError("in the frame")
    assert fake_sync_mode["modes"] == ["warn", 0]
    assert torch.cuda.synchronize is fake_sync_mode["stub"]
    assert warnings.filters == filters
    assert RECORDER.frames == 1 and RECORDER.open_stages == []


def test_renderer_profile_has_no_idle_split_on_the_cpu():
    r = Renderer(device="cpu")
    assert r.profile(filled_mmark(1, float(SIZE)), PARAMS) == {}
    assert r.last_profile["idle"] == {}


class _Raw:
    """A raw kineto event (what ``idle_by_range`` reads), times in us."""

    def __init__(self, name, start, end, device=DeviceType.CPU):
        self._v = (name, start, end, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1000)

    def duration_ns(self):
        return int((self._v[2] - self._v[1]) * 1000)

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[0].startswith("vt.") and self._v[3] != DeviceType.CPU


def test_idle_by_range_splits_gaps_and_runtime_calls():
    """vt.frame over [0, 100] us holds s01 [10, 40] and s02 [40, 90]; the
    device runs [0, 20] and [50, 60]. The gaps [20, 50] and [60, 100] split
    where the host moved from range to range; each range's host time is
    its self time; each runtime call counts under the range at its start;
    an aten op, an op-level ``vt_`` range and vt.frame's own device span
    are no range and no device work."""
    cuda = DeviceType.CUDA
    events = [_Raw("vt.frame", 0, 100), _Raw("s01_tile_alloc", 10, 40),
              _Raw("s02_flatten", 40, 90), _Raw("aten::sort", 41, 60),
              _Raw("vt_flatten", 12, 15),
              _Raw("cudaLaunchKernel", 12, 14),
              _Raw("cudaLaunchKernel", 44, 45),
              _Raw("cudaStreamSynchronize", 60, 85),
              _Raw("cudaLaunchKernel", 92, 93),
              _Raw("k0", 0, 20, cuda), _Raw("k1", 50, 60, cuda),
              _Raw("vt.frame", 0, 100, cuda)]
    got = idle_by_range(events, iters=2)
    ms = 1e-3 / 2
    assert got == {
        FRAME: {"idle_ms": pytest.approx(10 * ms),
                "host_ms": pytest.approx(20 * ms),
                "runtime_ms": {"cudaLaunchKernel": pytest.approx(ms)},
                "runtime_calls": {"cudaLaunchKernel": 0.5}},
        "s01_tile_alloc": {"idle_ms": pytest.approx(20 * ms),
                           "host_ms": pytest.approx(30 * ms),
                           "runtime_ms": {"cudaLaunchKernel":
                                          pytest.approx(2 * ms)},
                           "runtime_calls": {"cudaLaunchKernel": 0.5}},
        "s02_flatten": {"idle_ms": pytest.approx(40 * ms),
                        "host_ms": pytest.approx(50 * ms),
                        "runtime_ms": {
                            "cudaLaunchKernel": pytest.approx(ms),
                            "cudaStreamSynchronize": pytest.approx(25 * ms)},
                        "runtime_calls": {"cudaLaunchKernel": 0.5,
                                          "cudaStreamSynchronize": 0.5}}}


def test_idle_by_range_puts_gaps_outside_every_range_apart():
    cuda = DeviceType.CUDA
    events = [_Raw("s10_composite", 10, 20), _Raw("k0", 0, 5, cuda),
              _Raw("k1", 30, 40, cuda)]
    got = idle_by_range(events, iters=1)
    assert got[OUTSIDE]["idle_ms"] == pytest.approx(15e-3)
    assert got["s10_composite"]["idle_ms"] == pytest.approx(10e-3)
    assert OUTSIDE in got and got[OUTSIDE]["host_ms"] == 0.0
    assert idle_by_range([_Raw("s10_composite", 0, 1)], iters=1) == {}
