"""The port's Renderer API against the JAX package's: ``warmup`` and the
keys of ``last_profile`` (on the CPU, the kernels' plain versions). The
unfused geometry path that ``VELLO_TPU_NO_FUSED_GEOM`` selects renders
through every entry point: tests/test_torch_unfused.py."""

import numpy as np
import pytest

import vello_tpu_torch as vt
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.kurbo import circle_path, star_path

SIZE = 48


def _scene():
    s = vt.Scene()
    a = vt.Affine.identity()
    s.fill(vt.Fill.NON_ZERO, a, vt.palette.RED, None,
           circle_path(20, 22, 15))
    s.fill(vt.Fill.EVEN_ODD, a, vt.Color(0.2, 0.5, 0.9, 0.7), None,
           star_path(28, 26, 5, 6, 18))
    return s


@pytest.mark.parametrize("out", ["f32", "rgba8"])
def test_last_profile_has_the_jax_keys(out):
    """The keys the JAX Renderer writes (vello_tpu/models/renderer.py,
    render_resolved): wall_s up to the readback, readback_s the image's
    device-to-host copy, the tier, retries, layered, n_live, est."""
    params = RenderParams(SIZE, SIZE, antialiasing="msaa16")
    r = Renderer(device="cpu")
    r.render_resolved(resolve(_scene().encoding, params), params, out=out)
    prof = r.last_profile
    assert {"wall_s", "readback_s", "tier", "retries", "layered", "n_live",
            "est"} <= set(prof)
    assert prof["wall_s"] > 0.0 and prof["readback_s"] >= 0.0
    assert prof["retries"] == 0 and prof["layered"] is False
    assert set(prof["tier"]) >= {"lines", "touches", "path_tiles"}


def test_warmup_leaves_a_frame_thunk():
    """warmup renders once and discards the image; the frame it leaves
    behind re-renders the image that render gives."""
    params = RenderParams(SIZE, SIZE, base_color=(0.1, 0.1, 0.1, 1.0))
    r = Renderer(device="cpu")
    assert r.frame_thunk() is None
    assert r.warmup(_scene(), params) is None
    assert r.last_profile["retries"] == 0
    img, overflow = r.frame_thunk()()
    assert int(overflow) == 0
    np.testing.assert_array_equal(
        img.numpy(), Renderer(device="cpu").render(_scene(), params))
