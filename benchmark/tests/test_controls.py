"""The output check fails its controls and the faults a cell can have,
at a tiny size on the CPU: the port's render_mode "speed" (bf16 colors
in the composite), the reference's composite computed in bfloat16 in the
program's place, and the timed path broken underneath a run: a frame
left as allocated, half of it left out, a tile row of it altered where
it is produced."""

import pytest
import torch

from benchmark.tests.conftest import run_cell


@pytest.mark.parametrize("cell, control", [
    ("mmark.resident", "speed"), ("mmark.resident", "bf16")])
def test_control_fails(cell, control, capsys):
    rc, res, _ = run_cell(cell, control=control, capsys=capsys)
    assert rc == 0 and res["correct"] is False
    c = res["checks"]["diff_share"]
    assert c["value"] > c["limit"]


def _fault(kind):
    def broken(img):
        if kind == "unchanged":
            return torch.zeros_like(img)
        out = img.clone()
        if kind == "half":
            out[out.shape[0] // 2:] = 0
        else:                                   # "altered"
            out[:16] ^= 1
        return out
    return broken


@pytest.fixture
def break_frames(monkeypatch):
    """Break the port's frames where they are produced: the resident
    frame's thunk."""
    from vello_tpu_torch.models.renderer import Renderer

    def apply(kind):
        fault = _fault(kind)
        thunk_of = Renderer.frame_thunk

        def frame_thunk(self):
            f = thunk_of(self)

            def g():
                img, overflow = f()
                return fault(img), overflow
            return g

        monkeypatch.setattr(Renderer, "frame_thunk", frame_thunk)
    return apply


@pytest.mark.parametrize("cell", ["mmark.resident"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_frames_fail(cell, kind, break_frames, capsys):
    break_frames(kind)
    rc, res, _ = run_cell(cell, capsys=capsys)
    assert rc == 0 and res["correct"] is False
    c = res["checks"]["diff_share"]
    assert c["value"] > c["limit"]
