"""The port's layered compositor against the JAX package's, on the CPU:
whole 128x128 frames through ``Renderer(device="cpu")`` and the JAX
Renderer on its Pallas kernels in interpret mode (the scenes are
test_torch_layers_plan.py's): the same tier, retries and live cap, u8
images within 1 level with at least 99% of the bytes identical. The colors
and the base (0.12) keep flat regions off u8 half levels, where the JAX
package's log/exp walk would flip a whole region by one level.
"""

import numpy as np
import pytest

import vello_tpu_torch
from test_torch_layers_plan import (BASE, SIZE, clips,  # noqa: F401
                                    jax_interpret, resolve_both)
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.models.renderer import Renderer as JaxRenderer
from vello_tpu_torch import Renderer, RenderParams
from vello_tpu_torch.ops import kernels
from vello_tpu_torch.pipeline import layered


# ---------------------------------------------------------------------------
# whole frames

def spy_composites(monkeypatch):
    """Count the composite wrappers' calls."""
    calls = {"composite_over": 0, "composite_src": 0, "composite_solid": 0}

    def spy(wrapper):
        original = getattr(kernels, wrapper)

        def wrapped(*args, **kwargs):
            calls[wrapper] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(kernels, wrapper, wrapped)

    for name in calls:
        spy(name)
    return calls


def render_both(name, params, out="rgba8"):
    ours, ref, jparams = resolve_both(name, params)
    port = Renderer(device="cpu")
    got = port.render_resolved(ours, params, out=out)
    ref_r = JaxRenderer()
    want = ref_r.render_resolved(ref, jparams, out=out)
    for k in ("tier", "retries", "n_live", "layered"):
        assert port.last_profile[k] == ref_r.last_profile[k], k
    assert port.last_profile["layered"] and port.last_profile["retries"] == 0
    return got, want, ours, port.last_profile


def check_frame(monkeypatch, name, aa, opaque=True, uncapped=False):
    calls = spy_composites(monkeypatch)
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
    got, want, ours, prof = render_both(name, params)
    assert (prof["n_live"] == 0) == uncapped
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99
    if opaque:
        assert got[..., 3].min() == 255          # opaque base everywhere
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 8
    plan = layered.build_layer_plan(ours)[1]
    assert calls == {"composite_over": layered.nonempty_draws(plan),
                     "composite_src": 0, "composite_solid": 0}
    return plan


@pytest.mark.parametrize("name", ["layered_mmark", "clips", "masks",
                                  "compose_modes", "filters", "dense_clips"])
def test_layered_frame_matches_jax(jax_interpret, monkeypatch, name):
    """(blend_grid's 16 mixes are held to the JAX package's one by one in
    test_blend_matches_jax; compose_modes runs four of them in a frame.)
    CLEAR, SRC_IN and their kin clear the backdrop inside their cells."""
    check_frame(monkeypatch, name, "msaa16", opaque=name != "compose_modes",
                uncapped=name == "dense_clips")


def test_layered_area_frame_matches_jax(jax_interpret, monkeypatch):
    """The clip scene in area AA (both frames take the two fused
    multiply-adds that XLA-CPU contracts in the area formula, see
    test_torch_area.py)."""
    check_frame(monkeypatch, "clips", "area")


def test_u8_rule_where_alpha_quantizes_to_zero(jax_interpret):
    """A luminance mask over the whole frame leaves alphas near 0. The
    premultiplied f32 frames agree within 2e-5, and the u8 frames within 1
    level at every pixel, those whose alpha quantizes to 0 included: the
    layered path quantizes by the JAX package's layered rule
    (``renderer._to_rgba8_device``: unpremultiply down to alpha 1e-6), not
    by the flat paths' rgb = 0 below alpha 1/510 (``tiles_to_image``)."""
    params = RenderParams(SIZE, SIZE, base_color=BASE,
                          antialiasing="msaa16")
    got, want, _, _ = render_both("luminance_masks", params, out="f32")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    got8, want8, _, _ = render_both("luminance_masks", params)
    vis = want[..., 3] >= 1.0 / 510.0
    assert (~vis).any() and vis.mean() > 0.5
    diff = np.abs(got8.astype(np.int16) - want8.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    assert got8[~vis][:, :3].any()          # unpremultiplied, not zeroed


def test_renderer_layers_and_frame_thunk():
    """A clip layer renders through render_u8 and render (no
    NotImplementedError); the frame thunk re-runs the layered frame."""
    params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing="msaa16")
    r = Renderer(device="cpu")
    scene = clips(vello_tpu_torch)
    u8 = r.render_u8(scene, params)
    assert r.last_profile["layered"]
    img, overflow = r.frame_thunk()()
    assert int(overflow) == 0
    np.testing.assert_array_equal(img.numpy(), u8)
    f32 = r.render(scene, params)
    assert f32.dtype == np.float32 and (f32[..., :3] <= f32[..., 3:]
                                        + 1e-7).all()
