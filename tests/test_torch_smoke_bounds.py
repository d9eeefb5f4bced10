"""The work counts behind ``chip_smoke.py``'s bounds against brute-force
counts on small inputs: K1's live fill slots, stroke slots and (stroked
segment, mini) pairs, K2's live touches and the lines they fall in, the
input bytes K1 and K2 read (the owners' columns and scan entries), K5's
crossed tile rows and K3's crossed sample rows (the sample rows at
y + (s + 0.5) / ns of every tile row y) and its rows by path, and the
bytes the segment preparation and the occlusion walk read and write."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from test_torch_pipeline import one_torch_thread  # noqa: E402,F401
import chip_smoke  # noqa: E402


def _owners(incl, n_slots):
    """Brute force: (slot, owner, slot - owner's offset) of every live
    slot, walking the counts."""
    out, p = [], 0
    for s, hi in enumerate(incl):
        while p < hi and p < n_slots:
            lo = incl[s - 1] if s else 0
            out.append((p, s, p - lo))
            p += 1
    return out


def _scan_bytes(owners, n):
    """Brute force: the scan entries up to the last owner, and the total."""
    read = set(range(max(owners) + 1)) if owners else set()
    return 4 * len(read | {n - 1})


def _counts(rng, n, zero_runs):
    c = rng.integers(1, 30, n)
    if zero_runs:
        c[rng.uniform(size=n) < 0.3] = 0
        c[n // 3:n // 3 + 5] = 0
        c[-4:] = 0
    return c


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cap_frac", [0.5, 1.0, 2.0])
def test_flatten_units_equal_a_brute_force_count(seed, cap_frac):
    rng = np.random.default_rng(seed)
    n = 60
    stroked = rng.uniform(size=n) < 0.5
    m = rng.integers(1, 5, n)
    counts = np.where(stroked, 7 * m, _counts(rng, n, seed > 0))
    if seed == 2:
        counts[::9] = 0                    # zero-count stroked segments
    incl = np.cumsum(counts).astype(np.int32)
    n_lines = max(int(incl[-1] * cap_frac), 1)
    spack = np.zeros((n, 21), np.float32)
    spack[:, 19] = np.where(stroked, m, 0)
    want = {"fill_slots": 0, "stroke_slots": 0}
    minis = set()
    for _, s, sub in _owners(incl, n_lines):
        if stroked[s]:
            want["stroke_slots"] += 1
            minis.add((s, sub // 7))
        else:
            want["fill_slots"] += 1
    want["stroke_minis"] = len(minis)
    owners = {s for _, s, _ in _owners(incl, n_lines)}
    scan = _scan_bytes(owners, n)
    want["read_bytes"] = 4 * sum(21 if stroked[s] else 17
                                 for s in owners) + scan
    got = chip_smoke.flatten_units(torch.from_numpy(spack),
                                   torch.from_numpy(incl), n_lines)
    assert got == want
    fill_only = chip_smoke.flatten_units(torch.from_numpy(spack[:, :16]),
                                         torch.from_numpy(incl), n_lines)
    assert fill_only == {"fill_slots": want["fill_slots"]
                         + want["stroke_slots"], "stroke_slots": 0,
                         "stroke_minis": 0,
                         "read_bytes": 4 * 16 * len(owners) + scan}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cap_frac", [0.4, 1.0, 3.0])
def test_touch_units_equal_a_brute_force_count(seed, cap_frac):
    rng = np.random.default_rng(10 + seed)
    incl = np.cumsum(_counts(rng, 80, seed > 0)).astype(np.int32)
    n_touches = max(int(incl[-1] * cap_frac), 1)
    live = _owners(incl, n_touches)
    got = chip_smoke.touch_units(torch.from_numpy(incl), n_touches)
    lines = {s for _, s, _ in live}
    assert got == {"touches": len(live), "lines": len(lines),
                   "read_bytes": 4 * 13 * len(lines)
                   + _scan_bytes(lines, incl.shape[0])}


def test_no_live_slot_reads_only_the_total():
    incl = torch.zeros(9, dtype=torch.int32)
    assert chip_smoke.touch_units(incl, 5)["read_bytes"] == 4
    assert chip_smoke.flatten_units(torch.zeros((9, 16)), incl,
                                    5)["read_bytes"] == 4


def _fragments(seed, t=300, f=60):
    rng = np.random.default_rng(seed)
    fid = np.sort(rng.integers(0, f, t))
    trow = np.zeros((t, 8), np.float32)
    trow[:, 0:4] = rng.uniform(-1, 17, (t, 4))
    trow[::5, 1] = np.floor(trow[::5, 1])        # on a tile row
    trow[::7, 3] = trow[::7, 1]                  # horizontal
    starts = np.searchsorted(fid, np.arange(f + 1)).astype(np.int32)
    valid = rng.uniform(size=f) < 0.8
    return trow, starts, valid, rng


def test_crossed_rows_equal_a_brute_force_count():
    trow, starts, valid, _ = _fragments(3)
    want = 0
    for fr in range(len(valid)):
        if not valid[fr]:
            continue
        for t in trow[starts[fr]:starts[fr + 1]]:
            for row in range(16):
                y = np.float32(t[1] - np.float32(row))
                y1 = np.float32(y + np.float32(t[3] - t[1]))
                dyc = np.float32(np.clip(y, 0, 1) - np.clip(y1, 0, 1))
                want += dyc != 0.0
    got = chip_smoke.crossed_rows(*(torch.from_numpy(v) for v in
                                    (trow, starts, valid)))
    assert got == want


@pytest.mark.parametrize("ns", [8, 16])
def test_crossed_samples_equal_a_brute_force_count(ns):
    trow, starts, valid, rng = _fragments(4 + ns)
    fidx = rng.permutation(len(valid))[:45].astype(np.int32)
    sy = sorted({np.float32(r) + np.float32((s + 0.5) / ns)
                 for r in range(16) for s in range(ns)})
    assert len(sy) == 16 * ns
    want = 0
    for fr in fidx:
        if not valid[fr]:
            continue
        for t in trow[starts[fr]:starts[fr + 1]]:
            lo, hi = min(t[1], t[3]), max(t[1], t[3])
            want += sum(lo <= y < hi for y in sy)
    got = chip_smoke.crossed_samples(*(torch.from_numpy(v) for v in
                                       (trow, starts, fidx, valid)), ns)
    assert got == want


@pytest.mark.parametrize("has_evenodd", [False, True])
def test_msaa_row_paths_equal_a_brute_force_count(has_evenodd):
    """K3's rows by path: untouched or invalid; then by the backdrop and
    the count n of a touched row, the generic path for a backdrop that is
    not an integer below 2^16 or for 2 n + |backdrop| from 2^16 on, else
    even-odd (one plane) or the least of 4, 6, 8 and 16 planes whose range
    holds 2 n + |backdrop|."""
    rng = np.random.default_rng(5)
    f = 400
    counts = rng.integers(0, 140, f)
    counts[rng.uniform(size=f) < 0.2] = 0
    counts[:4] = (7, 8, 31, 32)                 # 2 n around 16 and 64
    counts[4], counts[5] = 40000, 32767         # around 2^16 touches
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    bd = rng.integers(-9, 10, f).astype(np.float32)
    bd[:4] = (1, 0, 1, 0)
    bd[5] = 2.0
    bd[6:12] = (0.5, -1.25, 65536.0, 65535.0, -65536.0, np.nan)
    rule = rng.integers(0, 2, f).astype(np.int32)
    valid = rng.uniform(size=f) < 0.9
    fidx = rng.permutation(f)[:333].astype(np.int32)
    want = {"untouched": 0, "evenodd": 0, "planes4": 0, "planes6": 0,
            "planes8": 0, "planes16": 0, "generic": 0}
    for fr in fidx:
        n = int(counts[fr]) if valid[fr] else 0
        b = float(bd[fr])
        if n == 0:
            want["untouched"] += 1
        elif not (b == np.round(b) and abs(b) < 65536):
            want["generic"] += 1
        elif 2 * n + abs(int(b)) >= 65536:
            want["generic"] += 1
        elif has_evenodd and rule[fr] == 1:
            want["evenodd"] += 1
        else:
            need = 2 * n + abs(int(b))
            k = next(k for k in (4, 6, 8, 16) if need < 2 ** k)
            want[f"planes{k}"] += 1
    got = chip_smoke.msaa_row_paths(
        *(torch.from_numpy(v) for v in (starts, fidx, bd, rule, valid)),
        has_evenodd)
    assert got == want
    assert sum(got.values()) == len(fidx)
    assert all(v > 0 for k, v in got.items()
               if has_evenodd or k != "evenodd")


def test_corpus_phase_holds_the_golden_tests_scenes_and_bars():
    """Phase 6's scene sizes, its Roboto and golden-only scenes and its
    three bars are those of test_reference_goldens.py's
    test_ported_scene_device_vs_oracle and of snapshot.py's defaults, read
    from their sources, so that the two cannot drift apart."""
    import inspect
    import re

    import snapshot
    import test_reference_goldens as goldens

    assert chip_smoke.CORPUS_SIZES == goldens.SIZES
    src = inspect.getsource(goldens.test_ported_scene_device_vs_oracle)
    roboto = re.search(r"if name in \(([^)]*)\)", src).group(1)
    assert sorted(re.findall(r'"(\w+)"', roboto)) == sorted(
        chip_smoke.ROBOTO_SCENES)
    assert re.findall(r'if name == "(\w+)":', src) == list(
        chip_smoke.GOLDEN_ONLY)
    oracle = re.findall(r"np\.abs\(dev - orc\)\.mean\(\) < ([0-9.e-]+)", src)
    assert [float(v) for v in oracle] == [chip_smoke.ORACLE_MEAN_TOL]
    means = re.findall(r'assert_snapshot\(f"ref_\{name\}", dev, '
                       r'mean_tol=([0-9.e-]+)\)', src)
    assert len(means) == 2
    assert {float(v) for v in means} == {chip_smoke.GOLDEN_MEAN_TOL}
    assert "max_tol" not in src           # the snapshot default applies
    sig = inspect.signature(snapshot.assert_snapshot)
    assert sig.parameters["max_tol"].default is None
    default = re.findall(r"max_tol = ([0-9.]+) / 255\.0",
                         inspect.getsource(snapshot.assert_snapshot))
    assert [float(v) / 255.0 for v in default] == [chip_smoke.GOLDEN_MAX_TOL]
    assert sorted(chip_smoke.corpus_names()) == sorted(
        set(goldens.SIZES) - set(chip_smoke.ROBOTO_SCENES))
    assert len(chip_smoke.corpus_names()) == 21


def test_raw_area_bound_counts_every_fragment_without_the_resolve():
    """K5's raw entry sums every fragment's touches and applies no
    backdrop, fill rule or threshold: its operations are K5's on the same
    touches with every fragment valid, less the per-pixel resolve."""
    trow, starts, valid, _ = _fragments(5)
    t, s = torch.from_numpy(trow), torch.from_numpy(starts)
    f = len(valid)
    out = torch.zeros((f, 256))
    raw = chip_smoke.bound("coverage_area_raw", (t, s), out)[2]
    k5 = chip_smoke.bound("coverage_area", (
        t, s, torch.zeros(f), torch.zeros(f, dtype=torch.int32),
        torch.ones(f, dtype=torch.bool)), out)[2]
    assert raw["touches"] == k5["touches"] == int(starts[-1] - starts[0])
    assert raw["crossed_rows"] == k5["crossed_rows"]
    assert raw["ops"] == k5["ops"] - f * 256 * chip_smoke.OPS_AREA_RESOLVE


def test_mesh_phase_cases_name_real_counters():
    """Phase 7: every case runs in exactly one world whose size is its
    n_dp * n_sp, and names launch counters the wrappers keep."""
    from vello_tpu_torch.ops import kernels

    placed = [c for _, _, cases in chip_smoke.MESH_WORLDS for c in cases]
    assert sorted(placed) == sorted(chip_smoke.MESH_CASES)
    for backend, world, cases in chip_smoke.MESH_WORLDS:
        assert backend in ("gloo", "nccl")
        for case in cases:
            _, aa, n_dp, n_sp, seeds, used = chip_smoke.MESH_CASES[case]
            assert n_dp * n_sp == world and len(seeds) % n_dp == 0
            assert set(used) <= set(kernels.launches)
            assert {"segment_prep", "flatten"} <= set(used)
            assert ("coverage_area_raw" in used) == (aa == "area")


@pytest.mark.parametrize("stroked", [False, True])
def test_segment_prep_bound_reads_each_input_once(stroked):
    """The segment preparation's bound: bytes alone, each segment's fields,
    n_segs and each path's 6 rect fields read once, the pack and the count
    scan written once."""
    from vello_tpu_torch.ops import kernels, tiling
    s, p = 50, 7
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(0, 100, (s, 4, 2)).astype(np.float32))
    kind = torch.from_numpy(rng.integers(1, 4, s).astype(np.int32))
    path = torch.from_numpy(rng.integers(0, p, s).astype(np.int32))
    rects = tiling.tile_alloc(torch.from_numpy(
        rng.integers(0, 5, (p, 4)).astype(np.int32)), 8, 8)
    hw = torch.full((s,), 2.0) if stroked else None
    join = torch.ones(s, dtype=torch.int32) if stroked else None
    args = (pts, kind, path, torch.tensor(s, dtype=torch.int32), rects, hw,
            join, 64)
    out = kernels.segment_prep(*args)
    ms, by, work = chip_smoke.bound("segment_prep", args, out)
    per_seg = 32 + 4 + 4 + (8 if stroked else 0)
    cols = 21 if stroked else 16
    assert by == "bytes" and work["ops"] == 0
    assert work["bytes"] == s * per_seg + 4 + 24 * p + s * (4 * cols + 4)
    assert ms == pytest.approx(work["bytes"] / chip_smoke.HBM_BYTES_PER_S
                               * 1e3)


@pytest.mark.parametrize("case", ["no_fragments", "empty_tiles",
                                  "window_covers", "stripe_tail", "random"])
def test_occlusion_bound_reads_the_walked_opaque_rows(case):
    """The occlusion walk's bound: bytes alone, of the opaque rows of each
    [los, his) the cover's whole row and one 32-byte sector of each other
    (a value below the threshold settles it), the opaque flags of those
    ranges and the ranges read, los written; its tiles with a cover and
    rows below a cover, against a brute force per tile."""
    import occlusion_cases
    _, cov, opaque, _, starts = occlusion_cases.cases()[case]
    los = occlusion_cases.walk(cov, opaque, starts)
    rows = flags = covers = hidden = 0
    for t in range(len(starts) - 1):
        lo, hi, j = int(starts[t]), int(starts[t + 1]), int(los[t])
        rows += int(opaque[j:hi].sum())
        flags += hi - j
        hidden += j - lo
        covers += int(hi > lo and opaque[j]
                      and bool(np.all(cov[j] >= occlusion_cases.THR)))
    args = tuple(torch.from_numpy(v) for v in (cov, opaque, starts))
    _, by, work = chip_smoke.bound("occlusion_los", args,
                                   torch.from_numpy(los))
    assert by == "bytes" and work["ops"] == 0
    assert work["walked_rows"] == rows
    assert work["tiles_with_cover"] == covers
    assert work["hidden_rows"] == hidden
    assert work["live_rows"] == int(starts[-1] - starts[0])
    assert work["bytes"] == (covers * 1024 + (rows - covers) * 32 + flags
                             + 4 * len(starts) + 4 * len(los))
