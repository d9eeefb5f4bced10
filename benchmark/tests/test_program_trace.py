"""The readers of the port's own host spans and sync counter
(``vello_tpu_torch.utils.profile.RECORDER``): None on an empty recorder,
on a program without one and in a run with no device trace, the mean per
recorded frame or span on a filled one."""

import types

import pytest

from benchmark import cells
from vello_tpu_torch.utils import profile

# reader -> its value on the recorder that ``filled`` makes
WANT = {"frame_host_ms": 12.0, "geometry_host_ms": 10.0,
        "coverage_host_ms": 0.5, "paint_host_ms": 0.25,
        "composite_host_ms": 1.0, "frame_syncs": 2.0,
        "resolve_decode_ms": 100.0, "resolve_paint_ms": 3.0,
        "resolve_estimate_ms": 450.0, "upload_ms": 20.0,
        "first_frame_ms": 900.0}


# a run on the card: the readers read only where there is a device trace
CARD = types.SimpleNamespace(trace=types.SimpleNamespace(busy_ns=1))
CPU = types.SimpleNamespace(trace=types.SimpleNamespace(busy_ns=0))


@pytest.fixture
def recorder():
    profile.RECORDER.reset()
    yield profile.RECORDER
    profile.RECORDER.reset()


def filled(rec):
    """4 frames of 12 ms; stages s01-s05 10 ms a frame (s02 twice), s06
    and s08 0.5, s09 0.25, s09b, s10 and s20 1; 8 syncs over the 4 CUDA
    frames; two resolves and one upload and first frame."""
    rec.frames, rec.frame_ns, rec.sync_frames = 4, 48_000_000, 4
    for name, ms in (("s01_tile_alloc", 1.0), ("s02_flatten", 3.0),
                     ("s03_touch_expand", 2.0), ("s04_coarse_sort", 3.5),
                     ("s05_segment_starts", 0.5), ("s06_coverage", 0.25),
                     ("s08_coverage_assembly", 0.25), ("s09_paint", 0.25),
                     ("s09b_occlusion", 0.5), ("s10_composite", 0.25),
                     ("s20_op_draws", 0.25)):
        rec.stage_ns[name] = int(ms * 4e6)
    rec.syncs.update({"s04_coarse_sort": 4, profile.FRAME: 4})
    for name, values in (("vt.resolve.decode", (0.09, 0.11)),
                         ("vt.resolve.paint", (0.002, 0.004)),
                         ("vt.resolve.estimate", (0.4, 0.5)),
                         ("vt.upload", (0.02,)),
                         ("vt.first_frame", (0.9,))):
        for v in values:
            rec.add(name, v)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_none_on_an_empty_recorder(recorder, metric):
    assert cells.reader(metric)(CARD) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_the_mean_on_a_filled_recorder(recorder, metric):
    filled(recorder)
    assert cells.reader(metric)(CARD) == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_none_without_a_device_trace(recorder, metric):
    """A CPU run: its host spans time the kernels' plain versions."""
    filled(recorder)
    assert cells.reader(metric)(CPU) is None
    assert cells.reader(metric)(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_is_none_without_a_recorder(monkeypatch, metric):
    """A program that records nothing of its own (an older commit)."""
    monkeypatch.delattr(profile, "RECORDER")
    assert cells.reader(metric)(CARD) is None


def test_the_manifest_lists_each_reader_for_the_cell():
    names = {m["name"] for m in cells.load("mmark.resident").per_layer}
    assert set(WANT) <= names
