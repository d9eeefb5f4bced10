"""The supersampled msaa path (``VELLO_TPU_SUPERSAMPLE_MSAA=1``) and the
``"centers"`` frame under it, the port against the JAX package on the CPU.

msaa8 and msaa16 render as 3x / 4x supersampling: the encoding scaled by
k, a "centers" frame at k*W x k*H (area coverage thresholded at 0.5 per
pixel, K5's centers epilogue), a k x k box resolve. Each scene is built
and resolved through its own package; the JAX Renderer runs its default
CPU path (``fine_xla.coverage_delta`` and a running cumsum differenced at
the segment starts). Bars:

- f32 frames within atol 2e-5, the same tier, retries and live cap,
  except the pixels with a sample whose unthresholded coverage lies
  within ``RESIDUE`` of the 0.5 threshold (found by rendering the port's
  frame with the threshold at 0.5 - RESIDUE and 0.5 + RESIDUE: a pixel
  that differs between the two has such a sample). There the JAX
  package's cumsum difference, which carries about an ulp of the running
  sum over the whole touch stream, may round the sample either way (per
  fragment, tests/test_torch_area.py excepts the same samples at 1e-5 on
  a 700-touch stream; the touch streams of these 512^2 centers frames are
  longer, and at 1e-5 one of the two differing pixels of filled_mmark
  msaa16 is not explained, at 1e-4 both are). Measured: filled_mmark
  msaa16 has 22 such pixels of 16384 (2 of them differ, by one sample,
  0.0095), msaa8 6 and centers 2 (none differs), the random paths none;
  at most ``MAX_EXCEPTED`` of the pixels are excepted;
- ``render_u8`` within one level of the JAX package's outside the same
  pixels, at least 99% of the bytes equal, and byte-equal to ``utils.png.to_rgba8`` of the port's
  own f32 frame (the port converts the resolved frame on the device);
- the port's frame within mean abs 2.5e-3 of the port's OracleRenderer,
  which renders msaa by the same supersampling (the corpus bar);
- the supersampled frame within mean abs ``SAMPLE_MASK_MEAN`` of the
  sample-mask msaa frame of the same scene (sample positions on a k x k
  grid against the D3D patterns; measured 0.0041 and 0.0046 on
  filled_mmark, the bar of chip_smoke.py's full-size comparison).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import vello_tpu
import vello_tpu_torch
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.models.renderer import Renderer as JaxRenderer
from vello_tpu.utils.png import to_rgba8 as jax_to_rgba8
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.oracle import OracleRenderer
from vello_tpu_torch.ops import kernels
from vello_tpu_torch.utils.png import to_rgba8

ENV = "VELLO_TPU_SUPERSAMPLE_MSAA"
BASE = (0.1, 0.1, 0.1, 1.0)
F32_ATOL = 2e-5
RESIDUE = 1e-4
MAX_EXCEPTED = 0.005
ORACLE_MEAN_TOL = 2.5e-3
SAMPLE_MASK_MEAN = 1e-2


def random_paths(pkg, size: int):
    """Five seeded closed paths (a line, a cubic and a quad each, partly
    off the canvas) of both fill rules, in translucent colors."""
    rng = np.random.default_rng(7)
    scene = pkg.Scene()
    for i in range(5):
        pts = rng.uniform(-4.0, size + 4.0, (7, 2))
        path = pkg.kurbo.BezPath()
        path.move_to(*pts[0])
        path.line_to(*pts[1])
        path.curve_to(*pts[2], *pts[3], *pts[4])
        path.quad_to(*pts[5], *pts[6])
        path.close()
        rgb = rng.uniform(0.1, 0.9, 3)
        rule = pkg.Fill.EVEN_ODD if i % 2 else pkg.Fill.NON_ZERO
        scene.fill(rule, pkg.Affine.identity(),
                   pkg.Color(*rgb, rng.uniform(0.5, 1.0)), None, path)
    return scene


def filled_mmark(pkg, size: int):
    ts = importlib.import_module(f"{pkg.__name__}.scenes.test_scenes")
    return ts.filled_mmark(2, float(size))


# scene -> (the function that builds it, size)
SCENES = {"random_paths": (random_paths, 64),
          "filled_mmark": (filled_mmark, 128)}
CASES = [(name, aa) for name in SCENES for aa in ("msaa8", "msaa16")]


def _params(pkg, name, aa):
    size = SCENES[name][1]
    return pkg.RenderParams(size, size, base_color=BASE, antialiasing=aa)


def _scene(pkg, name):
    build, size = SCENES[name]
    return build(pkg, size)


@pytest.fixture(autouse=True)
def supersample(monkeypatch):
    monkeypatch.setenv(ENV, "1")


@functools.lru_cache(maxsize=None)
def port_frame(name, aa, out="f32"):
    """(image, last_profile) of the port's CPU renderer."""
    r = Renderer(device="cpu")
    draw = r.render if out == "f32" else r.render_u8
    return draw(_scene(vello_tpu_torch, name),
                _params(vello_tpu_torch, name, aa)), r.last_profile


@functools.lru_cache(maxsize=None)
def jax_frame(name, aa):
    """(f32 image, last_profile) of the JAX package's Renderer."""
    r = JaxRenderer()
    return r.render(_scene(vello_tpu, name),
                    _params(vello_tpu, name, aa)), r.last_profile


def _threshold_at(t):
    """K5's plain version with the centers threshold at ``t``."""
    plain = kernels.coverage_area

    def coverage_area(trow, starts, backdrop, rule, valid, centers):
        cov = plain(trow, starts, backdrop, rule, valid, False)
        return torch.where(cov >= t, 1.0, 0.0) if centers else cov
    return coverage_area


@functools.lru_cache(maxsize=None)
def near_threshold(name, aa):
    """(H, W) bool: the pixels with a sample whose coverage lies within
    RESIDUE of 0.5, where the port's frame changes when the threshold
    moves from 0.5 - RESIDUE to 0.5 + RESIDUE (rendered with the variable
    set, as every test here runs)."""
    scene = _scene(vello_tpu_torch, name)
    params = _params(vello_tpu_torch, name, aa)
    frames = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, "1")
        for t in (0.5 - RESIDUE, 0.5 + RESIDUE):
            mp.setattr(kernels, "coverage_area", _threshold_at(t))
            frames.append(Renderer(device="cpu").render(scene, params))
    near = (frames[0] != frames[1]).any(axis=-1)
    assert near.mean() <= MAX_EXCEPTED, int(near.sum())
    return near


def assert_f32_close(name, aa, got, want):
    """The f32 bar: atol F32_ATOL outside the near-threshold pixels."""
    near = near_threshold(name, aa)
    diff = np.abs(got - want).max(axis=-1)
    assert diff[~near].max() <= F32_ATOL, (diff[~near].max(), int(near.sum()))
    # a near-threshold sample moves its pixel by at most one sample's share
    # of the frame's color
    assert diff.max() <= 1.0 / 9.0


@pytest.mark.parametrize("name,aa", CASES)
def test_supersampled_frame_matches_jax(name, aa):
    got, prof = port_frame(name, aa)
    want, jprof = jax_frame(name, aa)
    size = SCENES[name][1]
    assert got.shape == want.shape == (size, size, 4)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    for k in ("tier", "retries", "n_live"):
        assert prof[k] == jprof[k], k
    assert prof["retries"] == 0
    assert_f32_close(name, aa, got, want)
    assert len(np.unique(to_rgba8(got).reshape(-1, 4), axis=0)) > 8


@pytest.mark.parametrize("name,aa", CASES)
def test_supersampled_u8_matches_jax(name, aa):
    got, _ = port_frame(name, aa, "rgba8")
    want = JaxRenderer().render_u8(_scene(vello_tpu, name),
                                   _params(vello_tpu, name, aa))
    assert got.dtype == np.uint8 and got.shape == want.shape
    # outside the near-threshold pixels, where one sample's share of the
    # color (up to 0.0095 measured: 2 levels) may differ
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff[~near_threshold(name, aa)].max() <= 1
    assert (diff == 0).mean() >= 0.99
    # the device conversion is utils.png.to_rgba8 of the resolved frame
    np.testing.assert_array_equal(got, to_rgba8(port_frame(name, aa)[0]))
    np.testing.assert_array_equal(
        want, jax_to_rgba8(jax_frame(name, aa)[0]))


@pytest.mark.parametrize("name,aa", CASES)
def test_supersampled_frame_near_oracle(name, aa):
    got, _ = port_frame(name, aa)
    ref = OracleRenderer().render(_scene(vello_tpu_torch, name),
                                  _params(vello_tpu_torch, name, aa))
    assert ref.shape == got.shape
    assert float(np.abs(got - ref).mean()) < ORACLE_MEAN_TOL


@pytest.mark.parametrize("name,aa", CASES)
def test_supersampled_frame_near_sample_mask_frame(monkeypatch, name, aa):
    got, _ = port_frame(name, aa)
    monkeypatch.delenv(ENV)
    mask = Renderer(device="cpu").render(_scene(vello_tpu_torch, name),
                                         _params(vello_tpu_torch, name, aa))
    d = np.abs(got - mask)
    assert 0.0 < float(d.mean()) < SAMPLE_MASK_MEAN


@pytest.mark.parametrize("name", list(SCENES))
def test_centers_frame_matches_jax(name):
    """The "centers" frame itself, rendered directly (the variable does not
    touch it), through both packages at the f32 bar."""
    scene = _scene(vello_tpu_torch, name)
    params = _params(vello_tpu_torch, name, "centers")
    r = Renderer(device="cpu")
    got = r.render(scene, params)
    jr = JaxRenderer()
    want = jr.render(_scene(vello_tpu, name), _params(vello_tpu, name,
                                                      "centers"))
    for k in ("tier", "retries", "n_live"):
        assert r.last_profile[k] == jr.last_profile[k], k
    assert_f32_close(name, "centers", got, want)


def test_variable_read_at_call_time_and_frame_thunk(monkeypatch):
    """The variable is read at each call; a supersampled render leaves the
    centers frame behind ``frame_thunk`` and its tier in ``last_profile``;
    ``profile`` renders the params as given, as the JAX method does."""
    calls = {"msaa_coverage": 0, "coverage_area": 0}
    for wrapper in calls:
        def spy(*args, _w=wrapper, _f=getattr(kernels, wrapper)):
            calls[_w] += 1
            return _f(*args)
        monkeypatch.setattr(kernels, wrapper, spy)
    name, aa = "random_paths", "msaa16"
    scene = _scene(vello_tpu_torch, name)
    params = _params(vello_tpu_torch, name, aa)
    size = SCENES[name][1]
    r = Renderer(device="cpu")
    r.render(scene, params)
    assert calls == {"msaa_coverage": 0, "coverage_area": 1}
    img, overflow = r.frame_thunk()()
    assert int(overflow) == 0 and tuple(img.shape) == (4 * size, 4 * size, 4)
    up = vello_tpu_torch.Scene()
    up.append(scene, vello_tpu_torch.Affine.scale(4.0))
    big = RenderParams(4 * size, 4 * size, BASE, "centers")
    caps = resolve(up.encoding, big).capacities(big)
    assert tuple(r.last_profile["tier"].values()) == caps.key()
    assert r.last_profile["retries"] == 0
    assert r.last_profile["wall_s"] > 0.0
    assert calls == {"msaa_coverage": 0, "coverage_area": 2}
    monkeypatch.delenv(ENV)
    r.render(scene, params)
    assert calls == {"msaa_coverage": 1, "coverage_area": 2}
    monkeypatch.setenv(ENV, "1")
    assert r.profile(scene, params) == {}           # no device trace
    assert calls == {"msaa_coverage": 2, "coverage_area": 2}
    flat = resolve(scene.encoding, params).capacities(params)
    assert tuple(r.last_profile["tier"].values()) == flat.key()


def test_rgba8_device_equals_to_rgba8():
    """The device conversion gives ``utils.png.to_rgba8``'s bytes, also on
    alphas at and around the visibility cut 1/510, on alpha 0 and 1, and
    on values outside [0, 1]."""
    from vello_tpu_torch.models.renderer import rgba8_device
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (64, 64, 4)).astype(np.float32)
    cut = np.float32(1.0 / 510.0)
    alphas = np.array([0.0, 1.0, cut, np.nextafter(cut, np.float32(0)),
                       np.nextafter(cut, np.float32(1)), 1e-7, 0.5 / 255,
                       1.5 / 255], np.float32)
    img[0, :len(alphas), 3] = alphas
    img[1] = img[0] * 0.5
    got = rgba8_device(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, to_rgba8(img))
    assert (got[0, 3, :3] == 0).all()              # alpha below the cut
