"""The frozen roofline counts equal a brute-force count on small
inputs."""

import numpy as np
import pytest
import torch

from benchmark import roofline as rf


def _touches(gen, n_frag, per):
    """Random fragment-sorted touch rows (T, 8): [s0x, s0y, s1x, s1y, ...]
    in tile-local coordinates, with their fragments' starts."""
    counts = gen.integers(0, per + 1, size=n_frag)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    t = int(starts[-1])
    trow = np.zeros((t, 8), np.float32)
    trow[:, :4] = gen.uniform(-2.0, 18.0, size=(t, 4)).astype(np.float32)
    # some exact tile-row boundaries and horizontal touches
    trow[::5, 1] = np.floor(trow[::5, 1])
    trow[::7, 3] = trow[::7, 1]
    return torch.from_numpy(trow), torch.from_numpy(starts)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_crossed_rows(seed):
    gen = np.random.default_rng(seed)
    trow, starts = _touches(gen, 40, 6)
    valid = torch.from_numpy(gen.random(40) < 0.7)
    want = 0
    for f in range(40):
        if not valid[f]:
            continue
        for t in range(int(starts[f]), int(starts[f + 1])):
            y0, y1 = float(trow[t, 1]), float(trow[t, 3])
            for r in range(16):
                y = np.float32(y0 - r)
                a = min(max(y, np.float32(0.0)), np.float32(1.0))
                yy = np.float32(y + np.float32(np.float32(y1) - np.float32(y0)))
                b = min(max(yy, np.float32(0.0)), np.float32(1.0))
                want += int(np.float32(a - b) != 0.0)
    assert rf.crossed_rows(trow, starts, valid) == want


@pytest.mark.parametrize("ns", [8, 16])
def test_crossed_samples(ns):
    gen = np.random.default_rng(ns)
    trow, starts = _touches(gen, 30, 5)
    valid = torch.from_numpy(gen.random(30) < 0.8)
    fidx = torch.from_numpy(gen.choice(30, size=20, replace=False)
                            .astype(np.int32))
    want = 0
    for f in fidx.tolist():
        if not valid[f]:
            continue
        for t in range(int(starts[f]), int(starts[f + 1])):
            ymin = min(float(trow[t, 1]), float(trow[t, 3]))
            ymax = max(float(trow[t, 1]), float(trow[t, 3]))
            for row in range(16):
                for s in range(ns):
                    sy = np.float32(row + (s + 0.5) / ns)
                    want += int(ymin <= sy < ymax)
    assert rf.crossed_samples(trow, starts, fidx, valid, ns) == want


@pytest.mark.parametrize("n_slots", [0, 7, 30, 1000])
def test_live_slots_and_scan_bytes(n_slots):
    gen = np.random.default_rng(n_slots)
    counts = gen.integers(0, 5, size=20)
    incl = torch.from_numpy(np.cumsum(counts).astype(np.int32))
    live = rf._live_slots(incl, n_slots)
    total = min(int(incl[-1]), n_slots)
    owner = []
    for i, c in enumerate(counts):
        owner += [i] * int(c)
    want = np.bincount(owner[:total], minlength=20)
    assert live.tolist() == want.tolist()
    owners = [i for i in range(20) if want[i] > 0]
    read = owners[-1] + 1 if owners else 0
    assert rf._scan_bytes(live) == 4 * (read + int(read < 20))
    units = rf.touch_units(incl, n_slots)
    assert units["touches"] == total
    assert units["lines"] == len(owners)


def test_bound_takes_the_larger_of_bytes_and_operations():
    cov = torch.zeros((4, 256))
    col = torch.zeros((4, 4))
    base = torch.zeros(4)
    los = torch.tensor([0, 2], dtype=torch.int32)
    his = torch.tensor([2, 4], dtype=torch.int32)
    out = torch.zeros((2, 4, 256))
    ms, by, units = rf.bound("composite_solid", (cov, col, base, los, his),
                             out)
    walked = 4
    nbytes = (base.numel() + 2 + 2 + out.numel()) * 4 + walked * (256 + 4) * 4
    ops = walked * 256 * rf.OPS_PER_COMPOSITE
    assert units["bytes"] == nbytes and units["ops"] == ops
    assert ms == pytest.approx(max(nbytes / rf.HBM_BYTES_PER_S,
                                   ops / rf.F32_OPS_PER_S) * 1e3)
    assert by == ("bytes" if nbytes / rf.HBM_BYTES_PER_S
                  >= ops / rf.F32_OPS_PER_S else "operations")


def test_kernel_names():
    assert rf.kernel_of("void (anonymous namespace)::msaa_coverage_kernel"
                        "<16>(float const*)") == "msaa_coverage"
    assert rf.kernel_of("coverage_area_raw_kernel(float*)") \
        == "coverage_area_raw"
    assert rf.kernel_of("composite_src_bf16_kernel") == "composite_src_bf16"
    assert rf.kernel_of("void at::native::elementwise_kernel") is None
