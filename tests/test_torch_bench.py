"""The port's bench (``vello_tpu_torch/bench.py``) on the CPU at a small
size: one ``main(["--cpu"])`` run gives its JSON line and the headline and
batched frames it rendered. The line has ``bench.py``'s keys (with the
port's renames and additions), the host numbers of each entry equal the
JAX package's resolve of the same scene, the headline frame equals the
Renderer's and is within 1 u8 level of the JAX package's
``get_pipeline(static, u8_out=True)`` frame (Pallas in interpret mode),
and each batched frame equals the headline frame."""

import contextlib
import dataclasses
import io
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vello_tpu
from vello_tpu.encoding.resolve import resolve as jax_resolve
from vello_tpu.models.renderer import pack_buffers as jax_pack_buffers
from vello_tpu.pipeline import render as jax_render
from vello_tpu.scenes import test_scenes as jax_scenes

from test_torch_pipeline import jax_interpret  # noqa: F401
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer, bench
from vello_tpu_torch.scenes import test_scenes

SMALL = {"BENCH_SIZE": "64", "BENCH_COMPLEXITY": "1", "BENCH_ITERS": "2",
         "BENCH_BATCH": "2", "BENCH_COLD": "0"}
CAPS_KEYS = ("tags", "points", "segs", "lines", "touches", "path_tiles",
             "paths", "transforms", "styles", "ramps", "edges")
# bench.py's keys of ``extra``, renamed where the port's quantity differs
# (compile_s, compile_s_empty_cache, cache), with the port's additions
EXTRA_KEYS = {"frame_ms", "batched_fps", "mlines_per_s", "alt_fps",
              "first_call_s", "build_s", "kernels", "encode_s", "scenes",
              "backend", "caps", "device", "launches", "batched"}
SCENE_KEYS = {"fps", "frame_ms", "resolve_s", "first_frame_s", "n_paths",
              "n_segs", "est_lines", "retries", "tier_lines",
              "tier_touches", "build_s", "encode_s", "launches", "caps"}
ALT_KEYS = {"fps", "frame_ms", "launches"}
# entry -> the scene builder of both packages
BUILDERS = {"headline": "filled_mmark", "stroked_mmark": "mmark",
            "gradient_image_mmark": "mixed_paint_mmark",
            "layered_mmark": "layered_mmark"}


@pytest.fixture(scope="module")
def run():
    """``bench.main(["--cpu"])`` at SMALL, bench.py's other settings at
    their defaults: {"line": its parsed stdout line, "lines": the stdout
    line count, "head": the Headline, "batch": the batched frames}."""
    kept = {}
    headline, batched = bench.headline, bench.batched

    def keep_headline(*args):
        kept["head"] = headline(*args)
        return kept["head"]

    def keep_batched(*args):
        out = batched(*args)
        kept["batch"] = out[2]
        return out

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in ("BENCH_AA", "BENCH_GENERAL", "VELLO_TPU_NO_FUSED_GEOM",
                  "VELLO_TPU_UNROLLED_LAYERS"):
            mp.delenv(k, raising=False)
        for k, v in SMALL.items():
            mp.setenv(k, v)
        mp.setattr(bench, "headline", keep_headline)
        mp.setattr(bench, "batched", keep_batched)
        with contextlib.redirect_stdout(out):
            bench.main(["--cpu"])
    lines = out.getvalue().strip().splitlines()
    kept.update(line=json.loads(lines[-1]), lines=len(lines))
    return kept


def test_cpu_line_has_the_bench_keys(run):
    line = run["line"]
    assert run["lines"] == 1
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    extra = line["extra"]
    assert set(extra) == EXTRA_KEYS
    assert line["unit"] == "fps"
    assert line["value"] == pytest.approx(1e3 / extra["frame_ms"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 177.0)
    assert extra["backend"] == "cpu"
    assert extra["device"]["platform"] == "cpu"
    assert extra["device"]["power_limit"] is None
    assert extra["build_s"] is None
    assert extra["kernels"] == {"lib": None, "built_at_start": False}
    assert set(extra["caps"]) == set(CAPS_KEYS)
    assert extra["batched"]["batch"] == 2 and extra["batched_fps"] > 0
    assert set(extra["alt_fps"]) == {"area_quality", "msaa16_speed"}
    assert all(set(e) == ALT_KEYS for e in extra["alt_fps"].values())
    assert set(extra["scenes"]) == set(BUILDERS) - {"headline"}
    for scene in extra["scenes"].values():
        assert set(scene) == SCENE_KEYS
        assert scene["retries"] == 0
    entries = [extra, extra["batched"], *extra["alt_fps"].values(),
               *extra["scenes"].values()]
    for e in entries:
        # a wall time and no per-frame event time (``device_ms`` is
        # gone), and under a CPU run no kernel launched
        assert e["frame_ms"] > 0 and "device_ms" not in e
        assert e["launches"] == {}


@pytest.mark.parametrize("entry", list(BUILDERS))
def test_host_numbers_equal_jax_resolve(run, entry):
    extra = run["line"]["extra"]
    jparams = vello_tpu.RenderParams(64, 64, base_color=bench.BASE,
                                     antialiasing="msaa16")
    ref = jax_resolve(getattr(jax_scenes, BUILDERS[entry])(
        1, 64.0).encoding, jparams)
    want = {"n_paths": ref.n_paths, "n_segs": ref.n_segs,
            "est_lines": ref.est_lines,
            "caps": dict(zip(CAPS_KEYS, ref.capacities(jparams).key()))}
    if entry == "headline":
        n = re.search(r"\((\d+) paths, (\d+) segs, ~(\d+) lines\)",
                      run["line"]["metric"])
        got = {"n_paths": int(n[1]), "n_segs": int(n[2]),
               "est_lines": int(n[3]), "caps": extra["caps"]}
    else:
        got = {k: extra["scenes"][entry][k] for k in want}
    assert got == want


def test_headline_frame_equals_renderer_and_near_jax(run, jax_interpret):
    head = run["head"]
    img = head.img.numpy()
    assert img.shape == (64, 64, 4) and img.dtype == np.uint8
    scene = test_scenes.filled_mmark(1, 64.0)
    np.testing.assert_array_equal(
        img, Renderer(device="cpu").render_u8(scene, head.params))
    jparams = vello_tpu.RenderParams(**dataclasses.asdict(head.params))
    ref = jax_resolve(jax_scenes.filled_mmark(1, 64.0).encoding, jparams)
    caps = ref.capacities(jparams)
    jstatic = jax_render.PipelineStatic(**{
        k: v for k, v in dataclasses.asdict(head.static).items()
        if k != "fused_geom"})
    slim = jax_render.wants_fused_geom(caps)
    jbufs = {k: jnp.asarray(np.asarray(v)) for k, v in jax_pack_buffers(
        ref, caps, jparams, slim=slim,
        paint8=slim and set(jstatic.kinds_present) <= {0}).items()}
    want, overflow = jax_render.get_pipeline(jstatic, u8_out=True)(jbufs)
    assert int(overflow) == 0
    diff = np.abs(img.astype(np.int16) - np.asarray(want).astype(np.int16))
    assert diff.max() <= 1
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 8


def test_batched_frames_equal_the_single_frame(run):
    frames = run["batch"]
    assert len(frames) == 2
    # B results, not one buffer written B times
    assert len({f.data_ptr() for f in frames}) == 2
    for f in frames:
        assert torch.equal(f, run["head"].img)


def test_raises_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""
