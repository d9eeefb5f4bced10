"""The port's CUDA kernels against their plain PyTorch versions, on the
card. CUDA kernels have no interpret mode, so without a GPU every test
here skips; run them on a GPU host with
``python -m pytest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

import occlusion_cases
import segment_cases
from vello_tpu_torch import Renderer, RenderParams, resolve
from vello_tpu_torch.models.renderer import (pack_buffers, pipeline_static,
                                             to_torch)
from vello_tpu_torch.ops import fine, kernels, pathtag, tiling
from vello_tpu_torch.pipeline import layered, render
from vello_tpu_torch.scenes.test_scenes import (blend_grid, filled_mmark,
                                                layered_mmark,
                                                mixed_paint_mmark, mmark)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("aa", ["msaa8", "msaa16", "area", "centers"])
def test_gpu_frame_equals_cpu_frame(cuda, aa):
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing=aa)
    rs = resolve(filled_mmark(2, 256.0).encoding, params)
    kernels.reset_launches()
    gpu = Renderer(device=cuda).render_resolved(rs, params, out="rgba8")
    counts = dict(kernels.launches)
    coverage = "msaa_coverage" if aa.startswith("msaa") else "coverage_area"
    used = {"segment_prep", "flatten", "expand_touches", coverage,
            "occlusion_los", "composite_solid"}
    assert counts == {k: int(k in used) for k in counts}, counts
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    np.testing.assert_array_equal(gpu, cpu)


def test_msaa_and_composite_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    t, f = 4000, 900
    fid = np.sort(rng.integers(0, f, t))
    trow = np.zeros((t, 8), np.float32)
    trow[:, 0:4] = rng.uniform(-1, 17, (t, 4))
    trow[:, 4] = np.where(rng.uniform(size=t) < 0.3,
                          rng.uniform(0, 16, t), 1e9)
    starts = torch.from_numpy(np.searchsorted(fid, np.arange(f + 1))
                              .astype(np.int32)).to(cuda)
    args = (torch.from_numpy(trow).to(cuda), starts,
            torch.from_numpy(rng.permutation(f).astype(np.int32)).to(cuda),
            torch.from_numpy(rng.integers(-2, 3, f).astype(np.float32))
            .to(cuda),
            torch.from_numpy(rng.integers(0, 2, f).astype(np.int32)).to(cuda),
            torch.from_numpy(rng.uniform(size=f) < 0.9).to(cuda))
    for ns in (8, 16):
        got = kernels.msaa_coverage(*args, ns=ns)
        ref = fine.msaa_coverage_plain(*args, ns=ns)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)

    cov = got
    a = torch.rand(f, 1, device=cuda)
    col = torch.cat([torch.rand(f, 3, device=cuda) * a, a], dim=1)
    base = torch.tensor([0.1, 0.2, 0.3, 1.0], device=cuda)
    g = 64
    bounds = torch.sort(torch.randint(0, f + 1, (g + 1,), device=cuda,
                                      dtype=torch.int32)).values
    los, his = bounds[:-1].contiguous(), bounds[1:].contiguous()
    torch.testing.assert_close(
        kernels.composite_solid(cov, col, base, los, his),
        fine.composite_solid_plain(cov, col, base, los, his),
        rtol=0, atol=2e-5)


def test_area_kernel_matches_plain(cuda):
    """K5 against its plain version: the same f32 op order and the same
    order of additions, so the bar is equality."""
    rng = np.random.default_rng(1)
    t, f = 6000, 1500
    fid = np.sort(rng.integers(0, f, t))
    trow = np.zeros((t, 8), np.float32)
    trow[:, 0:4] = rng.uniform(-1, 17, (t, 4))
    trow[::7, 3] = trow[::7, 1]                  # horizontal (dy == 0)
    trow[3::11, 2] = trow[3::11, 0]              # vertical (dx == 0)
    trow[:, 4] = np.where(rng.uniform(size=t) < 0.3,
                          rng.uniform(0, 16, t), 1e9)
    starts = np.searchsorted(fid, np.arange(f + 1)).astype(np.int32)
    args = [torch.from_numpy(v).to(cuda) for v in (
        trow, starts, rng.integers(-2, 3, f).astype(np.float32),
        rng.integers(0, 2, f).astype(np.int32), rng.uniform(size=f) < 0.9)]
    for centers in (False, True):
        got = kernels.coverage_area(*args, centers)
        ref = fine.coverage_area_plain(*args, centers)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def threshold_touches(ns: int, seed: int):
    """Fragment-sorted tile-local touches, mostly on the thresholds of the
    coverage kernels: crossing x exactly on a sample position x + c_s and
    one f32 ulp either side (sloped, with sy == y0, and vertical); sample
    rows exactly on ymin, ymax and y_edge; dy == 0 and dx == 0; coordinates
    far outside the tile and near-horizontal touches with large crossing
    x; one fragment of 400 touches; fragments with none; random touches.
    Returns numpy (trow (T, 8) f32, starts (F+1,) i32, backdrop (F,) f32
    integers, rule (F,) i32, valid (F,) bool)."""
    rng = np.random.default_rng(seed)
    offs = fine.sample_offsets(ns)
    f32 = np.float32

    def sample(k=None):
        s = int(rng.integers(ns)) if k is None else k
        x, y = int(rng.integers(16)), int(rng.integers(16))
        return f32(x + offs[s][0]), f32(y + offs[s][1])

    def flip(seg):
        return seg[2:] + seg[:2] if rng.uniform() < 0.5 else seg

    def on_threshold():
        sx, sy = sample()
        x0 = np.nextafter(sx, f32(rng.choice([-np.inf, np.inf]))) \
            if rng.uniform() < 0.6 else sx
        kind = rng.integers(3)
        if kind == 0:       # sloped, crossing at its start point
            y1 = sy + f32(rng.uniform(0.05, 5.0)) * f32(rng.choice([-1, 1]))
            return [x0, sy, x0 + f32(rng.uniform(-6, 6)), y1]
        if kind == 1:       # vertical through the sample
            return flip([x0, sy - f32(rng.uniform(0, 4)), x0,
                         sy + f32(rng.uniform(0.01, 4))])
        # sloped, with both ends on other sample rows
        _, sy2 = sample()
        return [x0, sy, f32(rng.uniform(-2, 18)), sy2]

    def on_rows():
        _, sy0 = sample()
        _, sy1 = sample()
        return [f32(rng.uniform(-1, 17)), sy0, f32(rng.uniform(-1, 17)), sy1]

    def level_or_plumb():
        x0, y0, x1, y1 = rng.uniform(-1, 17, 4).astype(f32)
        if rng.uniform() < 0.5:
            return [x0, y0, x1, y0 if rng.uniform() < 0.7 else sample()[1]]
        return [x0, y0, x0, y1]

    def far():
        if rng.uniform() < 0.5:
            x = rng.uniform(-1e5, 1e5, 2)
            y = rng.uniform(-60, 76, 2)
            return [f32(x[0]), f32(y[0]), f32(x[1]), f32(y[1])]
        # near-horizontal across a sample row: crossing x far outside
        _, sy = sample()
        h = f32(2.0 ** -int(rng.integers(10, 20)))
        return flip([f32(rng.uniform(-40, 56)), sy - h,
                     f32(rng.uniform(-40, 56)), sy + h])

    def plain():
        return list(rng.uniform(-1, 17, 4).astype(f32))

    kinds = (on_threshold, on_rows, level_or_plumb, far, plain)
    n_frag = 97
    counts = rng.integers(0, 12, n_frag)
    counts[rng.uniform(size=n_frag) < 0.2] = 0         # fragments with none
    counts[41] = 400
    rows = []
    for c in counts:
        for _ in range(c):
            seg = kinds[int(rng.integers(len(kinds)))]()
            if rng.uniform() < 0.35:
                ye = rng.choice([sample()[1], f32(rng.uniform(0, 16)),
                                 seg[1], seg[3]])
            else:
                ye = f32(1e9)
            rows.append(list(seg) + [ye, 0.0, 0.0, 0.0])
    trow = np.asarray(rows, dtype=f32).reshape(-1, 8)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    backdrop = rng.integers(-3, 4, n_frag).astype(f32)
    rule = rng.integers(0, 2, n_frag).astype(np.int32)
    valid = rng.uniform(size=n_frag) < 0.9
    valid[41] = True
    return trow, starts, backdrop, rule, valid


@pytest.mark.parametrize("has_evenodd", [False, True])
@pytest.mark.parametrize("ns", [8, 16])
def test_msaa_kernel_on_thresholds(cuda, ns, has_evenodd):
    """K3 equal to its plain version on touches that sit on its
    thresholds, for an odd number of rows in shuffled order (ns 8 packs
    two rows per CTA) and for none."""
    trow, starts, bd, rule, valid = threshold_touches(ns, 10 + ns)
    fidx = np.random.default_rng(ns).permutation(len(bd))[:-2]
    args = [torch.from_numpy(v).to(cuda) for v in (
        trow, starts, fidx.astype(np.int32), bd, rule, valid)]
    kernels.reset_launches()
    got = kernels.msaa_coverage(*args, ns=ns, has_evenodd=has_evenodd)
    assert kernels.launches["msaa_coverage"] == 1
    ref = fine.msaa_coverage_plain(*args, ns=ns, has_evenodd=has_evenodd)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(got[:, 0].sum()) > 0.0
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    empty = kernels.msaa_coverage(args[0], args[1], none, *args[3:], ns=ns,
                                  has_evenodd=has_evenodd)
    assert empty.shape == (0, 256) and kernels.launches["msaa_coverage"] == 1


# a row's touch counts around K3's bounds: the warp's 32 lanes (one
# staged chunk), and the windings that 4, 6, 8 and 16 bit planes hold
# (2 n + |backdrop| below 16, 64, 256, 2^16)
MSAA_ROW_TOUCHES = (0, 1, 4, 31, 32, 33, 127, 128, 129, 300)


def msaa_rows(ns: int, n: int, seed: int):
    """Fragments of n touches each, for every backdrop from -9 to 9 and
    both fill rules: random touches in and around the tile, or (every
    other fragment) coherent ones that cross every sample row with one
    sign and carry left-edge terms of one sign, so that the windings reach
    about 2 n; then fragments with dyadic fractional backdrops and one
    with an integral backdrop of 2^16 + 1 (K3's generic path), invalid
    fragments with touches, and fragments without touches for every
    backdrop. Returns numpy (trow, starts, backdrop, rule, valid)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    offs = fine.sample_offsets(ns)

    def random_touch():
        seg = rng.uniform(-1, 17, 4).astype(f32)
        if rng.uniform() < 0.3:         # an end on a sample row
            s = int(rng.integers(ns))
            seg[1] = f32(int(rng.integers(16)) + offs[s][1])
        if rng.uniform() < 0.15:        # vertical
            seg[2] = seg[0]
        ye = (rng.choice([f32(rng.uniform(0, 16)), seg[1], f32(-3)])
              if rng.uniform() < 0.3 else f32(1e9))
        return list(seg) + [ye]

    def coherent_touch():
        x = f32(rng.uniform(-1, 17))
        return [x, f32(-1), f32(x + rng.uniform(0.01, 2)), f32(17),
                f32(rng.uniform(-1, 16)) if rng.uniform() < 0.5
                else f32(1e9)]

    counts, bds, rules, valid, rows = [], [], [], [], []

    def fragment(c, bd, rule, ok=True, coherent=False):
        counts.append(c)
        bds.append(bd)
        rules.append(rule)
        valid.append(ok)
        for _ in range(c):
            rows.append((coherent_touch if coherent else random_touch)()
                        + [0.0, 0.0, 0.0])

    k = 0
    for bd in range(-9, 10):
        for rule in (0, 1):
            fragment(n, bd, rule, coherent=k % 2 == 1)
            k += 1
    for bd in (0.5, -1.5, 0.25, 65537.0):
        for rule in (0, 1):
            fragment(n, bd, rule, coherent=bd < 0)
    for bd in (0, 1, -2):
        fragment(n, bd, 0, ok=False)
    for bd in range(-9, 10):
        fragment(0, bd, int(bd % 2))
    trow = np.asarray(rows, dtype=f32).reshape(-1, 8)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (trow, starts, np.asarray(bds, f32),
            np.asarray(rules, np.int32), np.asarray(valid, bool))


@pytest.mark.parametrize("n", MSAA_ROW_TOUCHES)
@pytest.mark.parametrize("ns", [8, 16])
def test_msaa_kernel_on_touch_counts(cuda, ns, n):
    """K3 bit-equal to its plain version for rows of n touches: every
    backdrop from -9 to 9, fractional and large backdrops, nonzero and
    even-odd rules (and has_evenodd off), invalid rows and rows without
    touches, the rows in shuffled order of odd length, some twice."""
    trow, starts, bd, rule, valid = msaa_rows(ns, n, 100 * ns + n)
    rng = np.random.default_rng(n)
    fidx = rng.permutation(len(bd))
    fidx = np.concatenate([fidx, fidx[:5]])
    fidx = fidx[:len(fidx) - 1 + len(fidx) % 2]
    assert len(fidx) % 2 == 1
    args = [torch.from_numpy(v).to(cuda) for v in (
        trow, starts, fidx.astype(np.int32), bd, rule, valid)]
    for has_evenodd in (True, False):
        got = kernels.msaa_coverage(*args, ns=ns, has_evenodd=has_evenodd)
        ref = fine.msaa_coverage_plain(*args, ns=ns,
                                       has_evenodd=has_evenodd)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        # partly covered pixels: not a row of constants
        assert n == 0 or bool(((got > 0) & (got < 1)).any())


@pytest.mark.parametrize("centers", [False, True])
def test_area_kernel_on_thresholds(cuda, centers):
    """K5 equal to its plain version on the same touches (rows that the
    touches cross and rows they do not, the 400-touch fragment over many
    chunks), and on no fragments at all."""
    trow, starts, bd, rule, valid = threshold_touches(16, 3)
    args = [torch.from_numpy(v).to(cuda)
            for v in (trow, starts, bd, rule, valid)]
    kernels.reset_launches()
    got = kernels.coverage_area(*args, centers)
    assert kernels.launches["coverage_area"] == 1
    ref = fine.coverage_area_plain(*args, centers)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    empty = kernels.coverage_area(
        args[0], args[1][:1].contiguous(), args[2][:0], args[3][:0],
        args[4][:0], centers)
    assert empty.shape == (0, 256) and kernels.launches["coverage_area"] == 1


def test_area_raw_kernel_on_thresholds(cuda):
    """K5's raw entry equal to its plain version on the threshold touches
    and on no fragments, with its own launch counter; the backdrop and
    fill rule of the single-device K5 applied to it in torch give K5's
    rows exactly (the sharded area path's order)."""
    trow, starts, bd, rule, valid = threshold_touches(16, 3)
    args = [torch.from_numpy(v).to(cuda)
            for v in (trow, starts, bd, rule, valid)]
    kernels.reset_launches()
    got = kernels.coverage_area_raw(args[0], args[1])
    assert kernels.launches["coverage_area_raw"] == 1
    assert kernels.launches["coverage_area"] == 0
    torch.testing.assert_close(
        got, fine.coverage_area_raw_plain(args[0], args[1]), rtol=0, atol=0)
    cov = fine.apply_fill_rule(args[2][:, None] + got, args[3][:, None])
    cov = torch.where(args[4][:, None], cov, 0.0)
    torch.testing.assert_close(
        cov, kernels.coverage_area(*args, False), rtol=0, atol=0)
    empty = kernels.coverage_area_raw(args[0], args[1][:1].contiguous())
    assert empty.shape == (0, 256)
    assert kernels.launches["coverage_area_raw"] == 1


@pytest.mark.parametrize("aa", ["msaa16", "area"])
@pytest.mark.parametrize("scene,composite", [
    (mixed_paint_mmark, "composite_src"), (mmark, "composite_solid")])
def test_gpu_paint_and_stroke_frames_equal_cpu_frames(cuda, scene,
                                                      composite, aa):
    """Gradients and images through K6, device strokes through K1's stroke
    rows and K4: the GPU frame within 1 u8 level of the CPU frame (the
    paint evaluation's library ops may round a divide by a scalar or an
    atan2 differently on the two devices)."""
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing=aa)
    rs = resolve(scene(2, 256.0).encoding, params)
    kernels.reset_launches()
    gpu = Renderer(device=cuda).render_resolved(rs, params, out="rgba8")
    counts = dict(kernels.launches)
    coverage = "msaa_coverage" if aa == "msaa16" else "coverage_area"
    used = {"segment_prep", "flatten", "expand_touches", coverage,
            "occlusion_los", composite}
    assert counts == {k: int(k in used) for k in counts}, counts
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    diff = np.abs(gpu.astype(np.int16) - cpu.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_src_composite_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    f, g = 3000, 97
    a = rng.uniform(size=(f, 1, 256))
    a[rng.uniform(size=f) < 0.2] = 1.0
    src = torch.from_numpy(np.concatenate(
        [rng.uniform(size=(f, 3, 256)) * a, a], axis=1).astype(np.float32))
    bounds = np.sort(rng.integers(0, f + 1, g + 1)).astype(np.int32)
    args = (src.to(cuda), torch.tensor([0.1, 0.2, 0.3, 1.0], device=cuda),
            torch.from_numpy(bounds[:-1]).to(cuda),
            torch.from_numpy(bounds[1:]).to(cuda))
    torch.testing.assert_close(kernels.composite_src(*args),
                               fine.composite_src_plain(*args),
                               rtol=0, atol=2e-5)


def test_stroke_rows_kernel_matches_plain(cuda):
    """K1 on a stroked scene's segment pack: the same f32 op order and
    correctly rounded 1/sqrt on both sides, so the bar is equality."""
    params = RenderParams(512, 512, antialiasing="msaa16")
    rs = resolve(mmark(2, 512.0).encoding, params)
    caps = rs.capacities(params)
    captured = {}
    original = kernels.flatten_lines

    def spy(spack, *args):
        captured["args"] = (spack,) + args
        return original(spack, *args)

    kernels.flatten_lines = spy
    try:
        Renderer(device=cuda).render_resolved(rs, params, out="rgba8")
    finally:
        kernels.flatten_lines = original
    spack = captured["args"][0]
    assert spack.shape[1] == 21 and caps.n_lines == captured["args"][2]
    got = kernels.flatten_lines(*captured["args"])
    ref = kernels.flatten_lines_plain(*captured["args"])
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


# the segment preparation's scenes: mmark-30k at 1600x1600 (the
# benchmark's stroke soup: lines, quads and cubics), the fill-only blob
# field, and fills and strokes in one scene
SEGMENT_SCENES = {
    "mmark": (lambda: mmark(30, 1600.0), 1600),
    "filled_mmark": (lambda: filled_mmark(4, 1024.0), 1024),
    "mixed": (lambda: segment_cases.mixed_scene(4, 1024.0), 1024)}


@pytest.mark.parametrize("name", sorted(SEGMENT_SCENES)
                         + list(segment_cases.SYNTHETIC))
def test_segment_prep_kernel_matches_plain(cuda, name):
    """The segment preparation's kernels against their plain version on
    the card, bit for bit (int32 views: signed zeros too): the counts and
    their scan, and every column of the segment pack, the offsets from the
    scan included; one counted launch; 16 columns without strokes."""
    if name in SEGMENT_SCENES:
        build, size = SEGMENT_SCENES[name]
        case = segment_cases.scene_case(build(), size)
    else:
        case = segment_cases.synthetic_case(name)
    stroked = "seg_hw" in case
    keys = ("seg_pts", "seg_kind", "seg_path", "n_segs", "path_rect") + (
        ("seg_hw", "seg_join") if stroked else ())
    t = {k: torch.from_numpy(np.asarray(case[k])).to(cuda) for k in keys}
    rects = tiling.tile_alloc(t["path_rect"], case["wt"], case["ht"])
    args = (t["seg_pts"], t["seg_kind"], t["seg_path"], t["n_segs"], rects,
            t.get("seg_hw"), t.get("seg_join"), case["max_lines"])
    kernels.reset_launches()
    spack, incl = kernels.segment_prep(*args)
    assert kernels.launches["segment_prep"] == 1
    ref, ref_incl = kernels.segment_prep_plain(*args)
    assert spack.shape == ref.shape == (case["seg_kind"].shape[0],
                                        21 if stroked else 16)
    assert torch.equal(incl, ref_incl)
    bad = (spack.view(torch.int32) != ref.view(torch.int32)).any(dim=0)
    assert not bad.any(), f"columns differ: {bad.nonzero().flatten()}"
    counts = spack[:, 8].to(torch.int32)
    assert torch.equal(spack[:, 9].to(torch.int32), incl - counts)
    live = int(case["n_segs"])
    assert int(counts[live:].abs().sum()) == 0
    assert int(incl[-1]) == int(counts.sum()) > 0


def test_stroked_frame_makes_no_sync(cuda):
    """A warm stroked frame (mmark in msaa16, device strokes through the
    segment preparation and K1's stroke rows) enqueues without one
    host-device sync: torch's sync-debug mode at "error" raises on any."""
    params = RenderParams(512, 512, antialiasing="msaa16")
    rs = resolve(mmark(2, 512.0).encoding, params)
    r = Renderer(device=cuda)
    r.render_resolved(rs, params, out="rgba8")
    frame = r.frame_thunk()
    frame()
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, overflow = frame()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.launches["segment_prep"] == 1
    assert kernels.launches["occlusion_los"] == 1
    assert int(overflow) == 0 and tuple(img.shape) == (512, 512, 4)


OCCLUSION_CASES = occlusion_cases.cases()


def mmark_resident_occlusion_inputs(cuda, monkeypatch, seed=3200000099):
    """The (cov, opaque, starts_g) that the frame of the benchmark's
    ``mmark.resident`` cell hands the occlusion walk (its configuration
    and scene generator, colors from ``seed``)."""
    import json
    import os
    import sys
    import types

    import vello_tpu_torch as vt
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from benchmark.scenes import mmark_rs
    with open(os.path.join(root, "benchmark", "configs", "mmark.json")) as f:
        config = json.load(f)
    api = types.SimpleNamespace(Scene=vt.Scene, kurbo=vt.kurbo,
                                peniko=vt.peniko)
    scene = mmark_rs.build(api, config, seed, {})
    params = RenderParams(config["width"], config["height"],
                          tuple(config["base_color"]),
                          config["antialiasing"])
    captured = {}
    original = kernels.occlusion_los

    def wrapped(*args):
        captured["args"] = args
        return original(*args)

    monkeypatch.setattr(kernels, "occlusion_los", wrapped)
    Renderer(device=cuda).render_resolved(resolve(scene.encoding, params),
                                          params, out="rgba8")
    monkeypatch.setattr(kernels, "occlusion_los", original)
    return captured["args"]


@pytest.mark.parametrize("case", sorted(OCCLUSION_CASES)
                         + ["mmark_resident"])
def test_occlusion_kernel_matches_plain(cuda, monkeypatch, case):
    """The occlusion walk's starts: the kernel bit-identical to its plain
    version (amin, cummax, gather and clamp on the card) on
    ``occlusion_cases``, which the reverse walk also holds, and on the
    mmark.resident frame's own inputs."""
    if case == "mmark_resident":
        cov, opaque, starts = mmark_resident_occlusion_inputs(cuda,
                                                              monkeypatch)
    else:
        _, cov, opaque, _, starts = OCCLUSION_CASES[case]
        cov, opaque, starts = (torch.from_numpy(v).to(cuda)
                               for v in (cov, opaque, starts))
    kernels.reset_launches()
    got = kernels.occlusion_los(cov, opaque, starts)
    assert kernels.launches["occlusion_los"] == 1
    ref = kernels.occlusion_los_plain(cov, opaque, starts)
    assert got.dtype == ref.dtype == torch.int32
    assert torch.equal(got, ref)
    if case != "mmark_resident":
        np.testing.assert_array_equal(got.cpu().numpy(), occlusion_cases.walk(
            *(v.cpu().numpy() for v in (cov, opaque, starts))))


def test_full_cover_threshold_on_the_card(cuda):
    """torch on the card compares an f32 tensor against ``>= FULL_COVER``
    at FULL_COVER_F32, the kernel's threshold: of its f32 neighbours the
    one below fails, it and the one above pass, in a compare and after an
    amin."""
    thr = np.float32(kernels.FULL_COVER_F32)
    x = torch.tensor([np.nextafter(thr, np.float32(0)), thr,
                      np.nextafter(thr, np.float32(2))], device=cuda)
    assert (x >= kernels.FULL_COVER).tolist() == [False, True, True]
    rows = torch.ones((3, 256), device=cuda)
    rows[:, 100] = x
    assert (torch.amin(rows, dim=1) >= kernels.FULL_COVER).tolist() == [
        False, True, True]


def test_over_composite_kernel_matches_plain(cuda):
    """K7 against its plain version on random walks, in place: the same
    arithmetic in the same order, so the bar is equality; tiles with an
    empty walk keep their values."""
    rng = np.random.default_rng(4)
    f, g = 3000, 97
    a = rng.uniform(size=(f, 1, 256))
    a[rng.uniform(size=f) < 0.2] = 1.0
    src = torch.from_numpy(np.concatenate(
        [rng.uniform(size=(f, 3, 256)) * a, a], axis=1).astype(np.float32))
    bounds = np.sort(rng.integers(0, f + 1, g + 1)).astype(np.int32)
    los, his = bounds[:-1].copy(), bounds[1:].copy()
    his[::5] = los[::5]                          # some empty walks
    buf = torch.from_numpy(rng.uniform(size=(g, 4, 256)).astype(np.float32))
    args = (src.to(cuda), torch.from_numpy(los).to(cuda),
            torch.from_numpy(his).to(cuda))
    got = buf.to(cuda)
    ref = buf.to(cuda)
    kernels.reset_launches()
    out = kernels.composite_over(args[0], got, *args[1:])
    assert out is got and kernels.launches["composite_over"] == 1
    fine.composite_over_plain(args[0], ref, *args[1:])
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(got[::5].cpu(), buf[::5], rtol=0, atol=0)


def test_gpu_layered_frame_equals_cpu_frame(cuda):
    """layered_mmark at 256x256 in msaa16: K1, K2 and K3 once, K7 once per
    draws op with a non-empty path range, K4 and K6 not at all; the GPU
    frame equals the CPU frame."""
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing="msaa16")
    rs = resolve(layered_mmark(2, 256.0).encoding, params)
    n_draws = layered.nonempty_draws(layered.build_layer_plan(rs)[1])
    assert n_draws == 24
    kernels.reset_launches()
    r = Renderer(device=cuda)
    gpu = r.render_resolved(rs, params, out="rgba8")
    assert r.last_profile["layered"]
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want.update(segment_prep=1, flatten=1, expand_touches=1,
                msaa_coverage=1, composite_over=n_draws)
    assert counts == want, counts
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    np.testing.assert_array_equal(gpu, cpu)


@pytest.mark.parametrize("c", [1, 200, 256])
@pytest.mark.parametrize("t", [1, 4097, 147456])
def test_cumsum_kernel_matches_plain(cuda, t, c):
    """K8 against its plain version (each prefix summed in f64, rounded
    once): equal on values k/16, whose prefixes are exact in f32 (and so
    equal to torch.cumsum's too); within 2e-6 of the largest prefix on
    uniform values."""
    rng = np.random.default_rng(t + c)
    x = torch.from_numpy(rng.uniform(0, 1, (t, c)).astype(np.float32)).to(cuda)
    x16 = torch.floor(x * 16.0) / 16.0
    kernels.reset_launches()
    got16 = kernels.cumsum0(x16)
    got = kernels.cumsum0(x)
    assert kernels.launches["cumsum"] == 2
    torch.testing.assert_close(got16, kernels.cumsum0_plain(x16), rtol=0,
                               atol=0)
    torch.testing.assert_close(got16, torch.cumsum(x16, 0), rtol=0, atol=0)
    ref = kernels.cumsum0_plain(x)
    bar = 2e-6 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bar


def test_gpu_unrolled_layered_frame_equals_scan_frame(cuda, monkeypatch):
    """blend_grid at 256x256 in msaa16 on the unrolled formulation: K8 once
    per clipped push, K7 once per non-empty draws op; the frame equals the
    scan formulation's on the GPU (exact msaa clip prefixes) and the CPU's
    unrolled frame."""
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing="msaa16")
    rs = resolve(blend_grid(256.0).encoding, params)
    plan = layered.build_layer_plan(rs)[1]
    scan = Renderer(device=cuda).render_resolved(rs, params, out="rgba8")
    monkeypatch.setenv("VELLO_TPU_UNROLLED_LAYERS", "1")
    kernels.reset_launches()
    gpu = Renderer(device=cuda).render_resolved(rs, params, out="rgba8")
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want.update(segment_prep=1, flatten=1, expand_touches=1,
                msaa_coverage=1, composite_over=layered.nonempty_draws(plan),
                cumsum=layered.clipped_pushes(plan))
    assert counts == want and want["cumsum"] == 15, counts
    np.testing.assert_array_equal(gpu, scan)
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    np.testing.assert_array_equal(gpu, cpu)


# slot counts of 1, around a warp's 32 slots, around CTA sizes of 128 to
# 1024 slots (K1 runs 128 threads of one slot, K2 128 threads of two) and
# across several CTAs
SLOT_COUNTS = [1, 31, 32, 33, 127, 128, 129, 255, 256, 257, 511, 512, 513,
               1023, 1024, 1025, 2049, 5000]


def _segment_pack(rng, counts, m=None):
    """A (S, 16) segment pack, or (S, 21) with stroke columns where m is
    given (m > 0 marks a stroked segment, 7 m slots), and its inclusive
    count scan, as ops/flatten.flatten_fused builds them: cubics partly
    off the viewport, offsets from the counts, path rects of live and
    empty paths."""
    s = len(counts)
    incl = np.cumsum(counts).astype(np.int32)
    cols = [rng.uniform(-200.0, 1800.0, (s, 8)),
            counts[:, None], (incl - counts)[:, None],
            rng.integers(0, 60, (s, 4)), rng.integers(0, 3, (s, 1)),
            rng.integers(0, 5000, (s, 1))]
    if m is not None:
        hw = np.where(m > 0, rng.uniform(0.5, 12.0, s), 0.0)
        join = (rng.uniform(size=s) < 0.6) & (m > 0)
        jn = rng.normal(size=(s, 2)) * hw[:, None] * join[:, None]
        cols += [hw[:, None], jn, m[:, None], join[:, None]]
    spack = np.concatenate([np.asarray(c, np.float64) for c in cols],
                           axis=1).astype(np.float32)
    spack[0, 14] = 2.0                       # the first path is live
    return spack, incl


def _flatten_cases(rng):
    """(name, counts, m) of segment packs at the partition's edges."""
    fill = rng.integers(1, 6, 3000)
    zeros = fill.copy()
    zeros[100:1400] = 0                      # a zero run across CTAs
    zeros[2000:2010] = 0
    zeros[-300:] = 0                         # the padding tail
    long = fill.copy()
    long[500] = 64                           # MAX_LINES_PER_SEG
    long[1200] = 2600                        # across 2 CTA boundaries
    m = np.where(rng.uniform(size=3000) < 0.5, rng.integers(1, 28, 3000),
                 0)
    m[700] = 400                             # 2800 slots: across 2 CTAs
    m[701:760] = 0
    st = np.where(m > 0, 7 * m, fill)
    st[1500:1800] = 0                        # zero run, stroked and not
    m[1500:1800] = np.where(m[1500:1800] > 0, 1, 0)
    runs = _warp_zero_runs(fill)
    return [("fill", fill, None), ("zero_runs", zeros, None),
            ("long_segments", long, None), ("one_segment", fill[:1], None),
            ("stroke", st, m), ("one_stroke_segment", np.array([7 * 9]),
                                np.array([9])),
            ("stroke_zero_tail", np.concatenate([st, np.zeros(50, int)]),
             np.concatenate([m, np.zeros(50, int)])),
            ("warp_zero_runs", runs, None),
            ("few_segments", fill[:33], None)]


def _warp_zero_runs(counts):
    """Counts with zero runs of 31, 32, 33 and 64 owners after owners at
    several offsets, so that a warp's 32-owner window of the scan ends
    just before, on and just past the next owner with a slot."""
    out = counts.copy()
    at = 40
    for run in (31, 32, 33, 64, 31, 32, 33):
        out[at:at + run] = 0
        at += run + 1 + at % 7
    return out


@pytest.mark.parametrize("case", range(9))
def test_flatten_kernel_partition_edges(cuda, case):
    """K1 against its plain version, bit for bit, at the edges of the
    slot partition: zero-count runs in the middle and the tail and runs
    around a warp's 32-owner window, owners whose slots cross two and
    more CTAs (a 64-line segment, a 2600-line one, a 400-mini stroke),
    one segment and 33, 16 and 21 columns, and slot counts of 1, around
    CTA sizes and past the total."""
    rng = np.random.default_rng(100 + case)
    name, counts, m = _flatten_cases(rng)[case]
    spack, incl = _segment_pack(rng, counts, m)
    total = int(incl[-1])
    args = (torch.from_numpy(spack).to(cuda), torch.from_numpy(incl).to(cuda))
    for n_lines in SLOT_COUNTS + [total, total + 3000]:
        kernels.reset_launches()
        got = kernels.flatten_lines(*args, n_lines, 1617.0, 1600.0)
        assert kernels.launches["flatten"] == 1
        ref = kernels.flatten_lines_plain(*args, n_lines, 1617.0, 1600.0)
        assert torch.equal(got, ref), (name, n_lines)


def test_flatten_kernel_inconsistent_offsets(cuda):
    """Stroke slots whose offset column disagrees with the count scan (no
    caller builds such a pack) still equal the plain version: the kernel
    computes what the plain version computes for any pack."""
    rng = np.random.default_rng(7)
    m = rng.integers(1, 9, 400)
    spack, incl = _segment_pack(rng, 7 * m, m)
    spack[::3, 9] += rng.integers(-9, 9, spack[::3].shape[0])
    args = (torch.from_numpy(spack).to(cuda), torch.from_numpy(incl).to(cuda))
    for n_lines in (1025, int(incl[-1]) + 100):
        assert torch.equal(
            kernels.flatten_lines(*args, n_lines, 800.0, 700.0),
            kernels.flatten_lines_plain(*args, n_lines, 800.0, 700.0))


def _line_pack(rng, counts):
    """A (16, N) line pack as tiling.make_touches_from_linepack builds it:
    downward lines, partly vertical, horizontal or on tile boundaries,
    offsets from the counts, live and dead lines, path rects."""
    n = len(counts)
    incl = np.cumsum(counts).astype(np.int32)
    x0 = rng.uniform(0.0, 1600.0, n)
    y0 = rng.uniform(0.0, 1600.0, n)
    x1 = x0 + rng.normal(0.0, 40.0, n)
    y1 = y0 + np.abs(rng.normal(0.0, 40.0, n))
    x1[::7] = x0[::7]                        # vertical
    y1[3::11] = y0[3::11]                    # horizontal
    y0[5::13] = np.floor(y0[5::13] / 16.0) * 16.0   # on a tile row
    x1[9::17] = x0[9::17] + 16.0 * 300       # long: many touches
    tx0 = np.floor(np.minimum(x0, x1) / 16.0) - rng.integers(0, 2, n)
    ty0 = np.floor(y0 / 16.0)
    tx1 = np.ceil(np.maximum(x0, x1) / 16.0) + rng.integers(0, 2, n)
    ty1 = np.ceil(y1 / 16.0) + 1
    rows = [x0, y0, x1, y1, np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0),
            incl - counts, incl, (rng.uniform(size=n) < 0.9) * 1.0,
            tx0, ty0, tx1, ty1, tx1 - tx0, rng.integers(0, 9000, n),
            np.zeros(n), np.zeros(n)]
    rows[7][0] = 1.0                         # the first line is live
    return np.stack(rows).astype(np.float32), incl


@pytest.mark.parametrize("case", ["ones", "zero_runs", "long_lines",
                                  "one_line", "warp_zero_runs",
                                  "few_lines"])
def test_touch_kernel_partition_edges(cuda, case):
    """K2 against its plain version, bit for bit, at the edges of the
    slot partition: zero-count runs in the middle and the tail and runs
    around a warp's 32-owner window, lines of 101 and 1500 touches across
    two and more CTAs, one line and 31, and slot counts of 1, around CTA
    sizes and past the total."""
    rng = np.random.default_rng({"ones": 0, "zero_runs": 1,
                                 "long_lines": 2, "one_line": 3,
                                 "warp_zero_runs": 4,
                                 "few_lines": 5}[case])
    counts = rng.integers(1, 4, 4000)
    if case == "zero_runs":
        counts[300:1500] = 0
        counts[-500:] = 0
    elif case == "warp_zero_runs":
        counts = _warp_zero_runs(counts)
    elif case == "few_lines":
        counts = counts[:31]
    elif case == "long_lines":
        counts[1000] = 101
        counts[2000] = 1500
    elif case == "one_line":
        counts = np.array([1500])
    lpack, incl = _line_pack(rng, counts)
    args = (torch.from_numpy(lpack).to(cuda), torch.from_numpy(incl).to(cuda))
    total = int(incl[-1])
    for n_touches in SLOT_COUNTS + [total, total + 3000]:
        kernels.reset_launches()
        got = kernels.expand_touches(*args, n_touches)
        assert kernels.launches["expand_touches"] == 1
        ref = kernels.expand_touches_plain(*args, n_touches)
        assert torch.equal(got, ref), (case, n_touches)


def test_renderer_profile_names_the_stages(cuda):
    """Renderer.profile on the card: device ms per stage named sNN_*, the
    stages cover all but 5% of the device time, and K1's and K2's kernels
    fall under s02_flatten and s03_touch_expand."""
    r = Renderer(device=cuda)
    stages = r.profile(filled_mmark(4, 512.0),
                       RenderParams(512, 512, antialiasing="msaa16"))
    named = {k for k in stages if not k.startswith("_")}
    assert {"s02_flatten", "s03_touch_expand", "s08_coverage_assembly",
            "s10_composite"} <= named
    assert stages["_other"] <= 0.05 * stages["_total"]
    split = r.last_profile["kernels"]
    for kernel, stage in (("flatten_kernel", "s02_flatten"),
                          ("expand_touches_kernel", "s03_touch_expand")):
        where = {st for st, k in split if kernel in k}
        assert where == {stage}, (kernel, where)


@pytest.mark.parametrize("kernel", ["composite_src", "composite_over"])
def test_bf16_src_kernels_match_plain(cuda, kernel):
    """The bf16 instantiations of K6 and K7 (render_mode "speed") against
    their plain versions on bf16 src: each value widened exactly, the
    arithmetic and its order the f32 kernel's, so the bar is equality;
    each launch counts under its own name."""
    rng = np.random.default_rng(5)
    f, g = 3000, 97
    a = rng.uniform(size=(f, 1, 256))
    a[rng.uniform(size=f) < 0.2] = 1.0
    src = torch.from_numpy(np.concatenate(
        [rng.uniform(size=(f, 3, 256)) * a, a], axis=1).astype(np.float32))
    src = src.to(cuda).to(torch.bfloat16)
    bounds = np.sort(rng.integers(0, f + 1, g + 1)).astype(np.int32)
    los, his = bounds[:-1].copy(), bounds[1:].copy()
    his[::5] = los[::5]                          # some empty walks
    los, his = torch.from_numpy(los).to(cuda), torch.from_numpy(his).to(cuda)
    kernels.reset_launches()
    if kernel == "composite_src":
        base = torch.tensor([0.1, 0.2, 0.3, 1.0], device=cuda)
        got = kernels.composite_src(src, base, los, his)
        ref = fine.composite_src_plain(src, base, los, his)
    else:
        buf = torch.rand((g, 4, 256), device=cuda)
        got = kernels.composite_over(src, buf.clone(), los, his)
        ref = fine.composite_over_plain(src, buf.clone(), los, his)
        torch.testing.assert_close(got[::5], buf[::5], rtol=0, atol=0)
    assert kernels.launches[f"{kernel}_bf16"] == 1
    assert kernels.launches[kernel] == 0
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # the same values in f32 through the f32 kernel: the same result
    f32 = (kernels.composite_src(src.float(), base, los, his)
           if kernel == "composite_src"
           else kernels.composite_over(src.float(), buf.clone(), los, his))
    torch.testing.assert_close(got, f32, rtol=0, atol=0)


@pytest.mark.parametrize("scene,composite", [
    (filled_mmark, "composite_solid"), (mixed_paint_mmark,
                                        "composite_src_bf16"),
    (layered_mmark, "composite_over_bf16")])
def test_gpu_speed_frames_equal_cpu_frames(cuda, scene, composite):
    """render_mode "speed" on the card: solid colors rounded to bf16 into
    K4, bf16 src rows into K6's and K7's bf16 instantiations (K7 once per
    non-empty draws op); the GPU frame within 1 u8 level of the CPU frame,
    as for quality (the paint evaluation's library ops)."""
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing="msaa16", render_mode="speed")
    rs = resolve(scene(2, 256.0).encoding, params)
    kernels.reset_launches()
    r = Renderer(device=cuda)
    gpu = r.render_resolved(rs, params, out="rgba8")
    counts = dict(kernels.launches)
    want = {k: 0 for k in counts}
    want.update(segment_prep=1, flatten=1, expand_touches=1,
                msaa_coverage=1)
    if r.last_profile["layered"]:
        want[composite] = layered.nonempty_draws(
            layered.build_layer_plan(rs)[1])
    else:
        want.update({composite: 1, "occlusion_los": 1})
    assert counts == want, counts
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    diff = np.abs(gpu.astype(np.int16) - cpu.astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.mark.parametrize("aa", ["msaa16", "area"])
@pytest.mark.parametrize("scene", [filled_mmark, mmark])
def test_gpu_slot_geometry_matches_plain(cuda, monkeypatch, scene, aa):
    """The mesh's geometry at one shard on the card: the rank's decoded
    tag slots, inert rows (kind 0; in mmark, with a stroke style) among
    them, through the segment preparation and K1, one launch each, both
    bit-equal to their plain versions on the same inputs; the inert rows
    count no line, and the frame is within 1 u8 level of the
    single-device frame."""
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing=aa)
    rs = resolve(scene(2, 256.0).encoding, params)
    caps = rs.capacities(params)
    static = pipeline_static([rs], caps, params)
    bufs = to_torch(pack_buffers(rs, caps, params), cuda)
    monkeypatch.setattr(render.GeomShards, "all_reduce",
                        lambda self, t, op=None: t)
    captured = {}
    for name in ("segment_prep", "flatten_lines"):
        def spy(*args, _name=name, _orig=getattr(kernels, name)):
            captured[_name] = args
            return _orig(*args)
        monkeypatch.setattr(kernels, name, spy)
    kernels.reset_launches()
    img, overflow = render.render_frame(bufs, static, u8_out=True,
                                        geom=render.GeomShards(None, 0, 1))
    assert int(overflow) == 0
    assert kernels.launches["segment_prep"] == 1
    assert kernels.launches["flatten"] == 1
    monkeypatch.undo()
    args = captured["segment_prep"]
    kind, hw = args[1], args[5]
    inert = kind == 0
    assert inert.any() and (hw is not None) == (scene is mmark)
    if hw is not None:
        styled = pathtag.decode_and_transform(
            bufs["tags"], bufs["data"], bufs["transforms"], bufs["styles"],
            style_hw=bufs["style_hw"])["hw"] > 0
        assert (inert & styled).any()
    spack, incl = kernels.segment_prep(*args)
    ref, ref_incl = kernels.segment_prep_plain(*args)
    assert torch.equal(incl, ref_incl)
    assert torch.equal(spack.view(torch.int32), ref.view(torch.int32))
    assert not spack[inert, 8].any()
    fargs = captured["flatten_lines"]
    got = kernels.flatten_lines(*fargs)
    torch.testing.assert_close(got, kernels.flatten_lines_plain(*fargs),
                               rtol=0, atol=0)
    want, _ = render.render_frame(bufs, static, u8_out=True)
    assert np.abs(img.cpu().numpy().astype(np.int16)
                  - want.cpu().numpy().astype(np.int16)).max() <= 1


def test_gpu_supersampled_frame_equals_cpu_frame(cuda, monkeypatch):
    """VELLO_TPU_SUPERSAMPLE_MSAA on the card: msaa16 as a 512x512 centers
    frame of the scene scaled by 4 (K1, K2, K5 with its centers threshold,
    K4), resolved 4x4 on the device. The f32 frame is within 1e-6 of the
    CPU's (K5 is bit-equal to its plain version, so every sample
    thresholds the same way; the box mean may sum in another order), the
    u8 frame within a level, and the centers frame stays behind
    frame_thunk."""
    monkeypatch.setenv("VELLO_TPU_SUPERSAMPLE_MSAA", "1")
    params = RenderParams(128, 128, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing="msaa16")
    scene = filled_mmark(2, 128.0)
    r = Renderer(device=cuda)
    kernels.reset_launches()
    gpu = r.render(scene, params)
    counts = dict(kernels.launches)
    used = {"segment_prep", "flatten", "expand_touches", "coverage_area",
            "occlusion_los", "composite_solid"}
    assert counts == {k: int(k in used) for k in counts}, counts
    assert r.last_profile["retries"] == 0
    img, overflow = r.frame_thunk()()
    assert int(overflow) == 0 and tuple(img.shape) == (512, 512, 4)
    cpu_r = Renderer(device="cpu")
    cpu = cpu_r.render(scene, params)
    assert r.last_profile["tier"] == cpu_r.last_profile["tier"]
    np.testing.assert_allclose(gpu, cpu, rtol=0, atol=1e-6)
    # a box mean an ulp apart can round a byte the other way
    diff = np.abs(r.render_u8(scene, params).astype(np.int16)
                  - cpu_r.render_u8(scene, params).astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_bench_headline_on_the_card(cuda):
    """The port bench's headline entry at 256x256 on the card: K1-K4 once
    each in its first frame, a wall time and no per-frame event time
    (``device_ms`` is gone), and the frame's bytes equal to the
    Renderer's of the same scene."""
    from vello_tpu_torch import bench
    cfg = bench.Settings(complexity=4, size=256, iters=2, batch=2,
                         cold=False)
    head = bench.headline(cfg, cuda)
    assert head.launches == {"segment_prep": 1, "flatten": 1,
                             "expand_touches": 1, "msaa_coverage": 1,
                             "occlusion_los": 1, "composite_solid": 1}
    assert head.frame_ms > 0 and not hasattr(head, "device_ms")
    want = Renderer(device=cuda).render_u8(filled_mmark(4, 256.0),
                                           head.params)
    np.testing.assert_array_equal(head.img.cpu().numpy(), want)


@pytest.mark.parametrize("aa", ["area", "msaa16"])
@pytest.mark.parametrize("scene,composite", [
    ("text_heavy", "composite_solid"), ("glyph_runs", "composite_solid"),
    ("glyph_raster", "composite_src")])
def test_gpu_text_frames_equal_cpu_frames(cuda, scene, composite, aa):
    """Text drawn from the package's DejaVu Sans (sfnt.py) on the card:
    K1, K2, the coverage kernel and the composite once each, the frame
    within 1 u8 level of the CPU frame."""
    from vello_tpu_torch.scenes.test_scenes import glyph_runs, text_heavy
    built = (text_heavy(256.0, lines=8) if scene == "text_heavy"
             else glyph_runs(256.0, raster=scene == "glyph_raster"))
    params = RenderParams(256, 256, base_color=(0.1, 0.1, 0.1, 1.0),
                          antialiasing=aa)
    rs = resolve(built.encoding, params)
    kernels.reset_launches()
    gpu = Renderer(device=cuda).render_resolved(rs, params, out="rgba8")
    counts = dict(kernels.launches)
    coverage = "msaa_coverage" if aa == "msaa16" else "coverage_area"
    used = {"segment_prep", "flatten", "expand_touches", coverage,
            "occlusion_los", composite}
    assert counts == {k: int(k in used) for k in counts}, counts
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    diff = np.abs(gpu.astype(np.int16) - cpu.astype(np.int16))
    assert diff.max() <= 1, int(diff.max())


@pytest.mark.parametrize("kind", ["colr_v1", "bitmap"])
def test_gpu_color_glyph_frames_equal_cpu_frames(cuda, kind):
    """A COLR v1 glyph (sfnt.py's paint graph: clip and blend layers, K7
    once per non-empty draws op) and a bitmap glyph (a CBDT PNG decoded by
    utils.png.decode_png, an image rect: K6) of the fonts in
    assets/fonts/test/ on the card, in area: the frame within 1 u8 level
    of the CPU frame."""
    import os

    from vello_tpu_torch import Affine, Fill, Scene
    from vello_tpu_torch.text import FONT_DIR, Font, Glyph
    name = "ColrV1Paints.ttf" if kind == "colr_v1" else "CbdtStrikes.ttf"
    font = Font(os.path.join(FONT_DIR, "test", name))
    gid = font.glyph_id("❤" if kind == "bitmap" else "\U0001F3AF")
    if kind == "bitmap":
        img, _, _, ppem = font.bitmap_glyph(gid)
        assert img.data.shape == (48, 48, 4) and ppem == 48.0
    s = Scene()
    (s.draw_glyphs(font).font_size(96.0).transform(Affine.translate(0.5, 0))
     .draw(Fill.NON_ZERO, [Glyph(gid, 16.0, 100.0)]))
    params = RenderParams(128, 128, base_color=(0.1, 0.1, 0.1, 1.0))
    rs = resolve(s.encoding, params)
    want = {k: 0 for k in kernels.launches}
    want.update(segment_prep=1, flatten=1, expand_touches=1,
                coverage_area=1)
    if kind == "colr_v1":
        want["composite_over"] = layered.nonempty_draws(
            layered.build_layer_plan(rs)[1])
        assert want["composite_over"] > 1
    else:
        want.update(composite_src=1, occlusion_los=1)
    kernels.reset_launches()
    r = Renderer(device=cuda)
    gpu = r.render_resolved(rs, params, out="rgba8")
    assert dict(kernels.launches) == want, dict(kernels.launches)
    assert r.last_profile["layered"] == (kind == "colr_v1")
    cpu = Renderer(device="cpu").render_resolved(rs, params, out="rgba8")
    diff = np.abs(gpu.astype(np.int16) - cpu.astype(np.int16))
    assert diff.max() <= 1, int(diff.max())


def test_frame_sync_counter_on_the_card(cuda):
    """vt.frame's sync counter on the card: ``.item()``, ``int`` of a
    tensor, ``nonzero``, a device-to-host copy and
    ``torch.cuda.synchronize()`` count once each, under the stage open at
    the time (vt.frame outside every stage); the sync-debug mode is off
    again after the frame, and after one that raised. A real frame of the
    Renderer counts the same whole number every time, and the kernel
    library's load lies within its first frame."""
    from torch.profiler import ProfilerActivity, profile

    from vello_tpu_torch.utils.profile import (FRAME, RECORDER, frame_span,
                                               stage)
    x = torch.arange(8, device=cuda)
    RECORDER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with frame_span(True):
            with stage("s01_tile_alloc"):
                x.sum().item()
                int(x[3])
            with stage("s04_coarse_sort"):
                torch.nonzero(x > 3)
                x.cpu()
            torch.cuda.synchronize()
            x + 1
        with pytest.raises(RuntimeError):
            with frame_span(True):
                raise RuntimeError("in the frame")
    assert dict(RECORDER.syncs) == {"s01_tile_alloc": 2,
                                    "s04_coarse_sort": 2, FRAME: 1}
    assert RECORDER.sync_frames == 2
    assert torch.cuda.get_sync_debug_mode() == 0

    params = RenderParams(256, 256, antialiasing="msaa16")
    rs = resolve(filled_mmark(2, 256.0).encoding, params)
    r = Renderer(device=cuda)
    r.render_resolved(rs, params, out="rgba8")
    prof = r.last_profile
    assert 0.0 < prof["upload_s"] < prof["wall_s"]
    assert prof["kernels_load_s"] <= prof["first_frame_s"] < prof["wall_s"]
    thunk = r.frame_thunk()
    RECORDER.reset()
    counts = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            before = sum(RECORDER.syncs.values())
            thunk()
            counts.append(sum(RECORDER.syncs.values()) - before)
    torch.cuda.synchronize()
    assert RECORDER.frames == RECORDER.sync_frames == 3
    assert len(set(counts)) == 1, counts
    assert torch.cuda.get_sync_debug_mode() == 0
