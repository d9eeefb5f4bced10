"""The port's unrolled layered formulation (``VELLO_TPU_UNROLLED_LAYERS=1``,
clip coverage by ``segment_sum_sorted`` and so kernel K8) against its scan
formulation, on the CPU (the scenes are test_torch_layers_plan.py's):
identical in msaa16, whose clip coverage prefixes are exact in f32, and
within 1 level in area (against the JAX package's unrolled frames:
test_torch_unrolled.py).
"""

import numpy as np
import pytest

import vello_tpu_torch
from test_torch_layers_plan import BASE, SCENES, SIZE
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.ops import kernels, segmented
from vello_tpu_torch.pipeline import layered


# ---------------------------------------------------------------------------
# the unrolled formulation (VELLO_TPU_UNROLLED_LAYERS, kernel K8)

def spy_segment_sums(monkeypatch):
    """Count the calls of ``segmented.segment_sum_sorted`` and of K8's
    wrapper."""
    calls = {"segment_sum_sorted": 0, "cumsum0": 0}

    def spy(module, name):
        original = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(segmented, "segment_sum_sorted")
    spy(kernels, "cumsum0")
    return calls


@pytest.mark.parametrize("name,aa", [
    ("clips", "msaa16"), ("blend_grid", "msaa16"), ("masks", "msaa16"),
    ("clips", "area"), ("blend_grid", "area")])
def test_unrolled_frame_equals_scan_frame(monkeypatch, name, aa):
    """The port's two formulations on one resolved scene. msaa16 clip
    coverages are multiples of 1/16, so every prefix of the unrolled sum is
    exact and the f32 frames are equal; area coverages are not, and the
    cumsum differences may move a u8 level."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
    rs = resolve(SCENES[name](vello_tpu_torch).encoding, params)
    scan = Renderer(device="cpu").render_resolved(rs, params)
    scan8 = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    monkeypatch.setenv("VELLO_TPU_UNROLLED_LAYERS", "1")
    sums = spy_segment_sums(monkeypatch)
    unrolled = Renderer(device="cpu").render_resolved(rs, params)
    unrolled8 = Renderer(device="cpu").render_resolved(rs, params,
                                                       out="rgba8")
    assert sums["cumsum0"] == 2 * layered.clipped_pushes(
        layered.build_layer_plan(rs)[1]) > 0
    if aa == "msaa16":
        np.testing.assert_array_equal(unrolled, scan)
        np.testing.assert_array_equal(unrolled8, scan8)
    else:
        np.testing.assert_allclose(unrolled, scan, rtol=0, atol=1e-5)
        diff = np.abs(unrolled8.astype(np.int16) - scan8.astype(np.int16))
        assert diff.max() <= 1


@pytest.mark.parametrize("name", ["masks", "blend_grid"])
def test_renderer_takes_unrolled_path_when_asked(monkeypatch, name):
    """With VELLO_TPU_UNROLLED_LAYERS set, ``Renderer(device="cpu")`` takes
    the unrolled formulation: one ``segment_sum_sorted`` per clipped push
    (the masks scene's pushes without a clip take none); without it, the
    scan formulation takes none. The frame thunk keeps the formulation it
    was built with."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="msaa16")
    rs = resolve(SCENES[name](vello_tpu_torch).encoding, params)
    st, plan, _, _ = layered.build_layer_plan(rs)
    n = layered.clipped_pushes(plan)
    pushes = [op[0] for op in st.ops].count(layered.OP_PUSH)
    assert (n, pushes) == {"masks": (2, 5), "blend_grid": (15, 15)}[name]
    sums = spy_segment_sums(monkeypatch)
    Renderer(device="cpu").render_resolved(rs, params)
    assert sums == {"segment_sum_sorted": 0, "cumsum0": 0}
    monkeypatch.setenv("VELLO_TPU_UNROLLED_LAYERS", "1")
    r = Renderer(device="cpu")
    r.render_resolved(rs, params)
    assert r.last_profile["layered"]
    assert sums == {"segment_sum_sorted": n, "cumsum0": n}
    monkeypatch.delenv("VELLO_TPU_UNROLLED_LAYERS")
    _, overflow = r.frame_thunk()()
    assert int(overflow) == 0
    assert sums == {"segment_sum_sorted": 2 * n, "cumsum0": 2 * n}
