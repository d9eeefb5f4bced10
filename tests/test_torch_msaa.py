"""K3's plain version (the port's msaa coverage) against the JAX package's
``msaa_coverage_pallas`` in interpret mode, on the random touch streams of
test_kernels_interp.py. Coverage is a sum of k/ns values, exact in f32
and bf16 alike, so the bar is equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.ops.pallas_kernels import CK_M, WF_M, msaa_coverage_pallas
from vello_tpu_torch.ops import kernels


def _stream(seed):
    rng = np.random.default_rng(seed)
    t = 300                                  # not a CK multiple: covers pad
    runlen = rng.integers(1, 7, t)
    fid = np.sort(np.repeat(np.arange(len(runlen)), runlen)[:t])
    f = int(fid[-1]) + 1
    # tile-local segments incl. horizontals, verticals, out-of-range rows
    x0 = rng.uniform(-1, 17, t)
    y0 = rng.uniform(-1, 17, t)
    x1 = x0 + rng.uniform(-4, 4, t)
    y1 = y0 + rng.uniform(-4, 4, t)
    y1[::11] = y0[::11]                      # horizontal (dy == 0)
    x1[5::13] = x0[5::13]                    # vertical (dx == 0)
    ye = np.where(rng.uniform(size=t) < 0.3, rng.uniform(0, 16, t), 1e9)
    seg = np.stack([x0, y0, x1, y1], axis=1).astype(np.float32)
    backdrop = rng.integers(-2, 3, f).astype(np.float32)
    rule = rng.integers(0, 2, f).astype(np.int32)
    starts = np.searchsorted(fid, np.arange(f + 1)).astype(np.int32)
    trow = np.concatenate(
        [seg, ye.astype(np.float32)[:, None], np.zeros((t, 1), np.float32),
         fid.astype(np.float32)[:, None], np.zeros((t, 1), np.float32)],
        axis=1).astype(np.float32)
    return trow, fid, starts, backdrop, rule


def _pallas_rows(trow, fid, starts, backdrop, rule, ns, has_evenodd):
    """Fragment rows of the Pallas block-region output, gathered as
    test_kernels_interp.py does (every fragment here has a touch, so its
    rank is its id)."""
    f = len(backdrop)
    bdr = np.zeros((f + 8 + WF_M, 128), np.float32)
    bdr[:f, 0] = backdrop
    bdr[:f, 1] = rule
    out_t, w0b = msaa_coverage_pallas(jnp.asarray(trow), jnp.asarray(bdr),
                                      ns, has_evenodd=has_evenodd,
                                      ft_clip=f, interpret=True)
    b_last = (starts[1:] - 1) // CK_M
    rows = b_last * WF_M + np.arange(f) - np.asarray(w0b)[b_last]
    return np.asarray(out_t, dtype=np.float32)[rows]


@pytest.mark.parametrize("ns", [8, 16])
@pytest.mark.parametrize("has_evenodd", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_msaa_plain_equals_pallas(ns, has_evenodd, seed):
    trow, fid, starts, backdrop, rule = _stream(seed)
    if not has_evenodd:
        rule = np.zeros_like(rule)
    ref = _pallas_rows(trow, fid, starts, backdrop, rule, ns, has_evenodd)
    f = len(backdrop)
    got = kernels.msaa_coverage(
        torch.from_numpy(trow), torch.from_numpy(starts),
        torch.arange(f, dtype=torch.int32), torch.from_numpy(backdrop),
        torch.from_numpy(rule), torch.ones(f, dtype=torch.bool), ns,
        has_evenodd).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.mean() < 1


def test_msaa_rows_follow_fidx():
    """Rows come out in the requested (sorted-fragment) order; invalid
    fragments are 0 and a fragment without touches resolves its
    backdrop."""
    trow, fid, starts, backdrop, rule = _stream(1)
    f = len(backdrop)
    args = [torch.from_numpy(trow), torch.from_numpy(starts), None,
            torch.from_numpy(backdrop), torch.from_numpy(rule),
            torch.ones(f, dtype=torch.bool)]
    args[2] = torch.arange(f, dtype=torch.int32)
    full = kernels.msaa_coverage(*args, ns=16)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(f)
                            .astype(np.int32))
    args[2] = perm
    assert torch.equal(kernels.msaa_coverage(*args, ns=16),
                       full[perm.long()])
    args[2] = torch.arange(f, dtype=torch.int32)
    args[5] = torch.arange(f) % 2 == 0
    masked = kernels.msaa_coverage(*args, ns=16)
    assert torch.equal(masked[1::2], torch.zeros_like(masked[1::2]))
    assert torch.equal(masked[0::2], full[0::2])
    # empty fragment: starts[f] == starts[f+1]
    s2 = torch.cat([torch.from_numpy(starts), torch.tensor([starts[-1]],
                                                           dtype=torch.int32)])
    bd2 = torch.cat([torch.from_numpy(backdrop), torch.tensor([-1.0])])
    rl2 = torch.cat([torch.from_numpy(rule), torch.tensor([0],
                                                          dtype=torch.int32)])
    cov = kernels.msaa_coverage(
        args[0], s2, torch.tensor([f], dtype=torch.int32), bd2, rl2,
        torch.ones(f + 1, dtype=torch.bool), ns=8)
    assert torch.equal(cov, torch.ones(1, 256))


@pytest.mark.parametrize("ns", [8, 16])
def test_first_right_threshold_is_exact(ns):
    """The rule by which K3 (csrc/msaa_coverage.cu, first_right) finds, per
    touch and sample row, the first pixel x whose sample lies right of the
    crossing x: floor(xt - c_s) + 1 with the difference clamped to
    [-1, 16] in f32, no correcting compare. It must select exactly the
    pixels of the plain version's 16 f32 compares xt < x + c_s, at every
    sample position, 40 ulps either side, and over wide ranges of xt."""
    from vello_tpu_torch.ops.fine import sample_offsets
    f32 = np.float32
    rng = np.random.default_rng(ns)
    pixels = np.arange(16).astype(f32)
    for cx, _ in sample_offsets(ns):
        cs = f32(cx)
        on = (np.arange(-3, 20).astype(f32) + cs).astype(f32)
        xs = [on]
        for direction in (np.inf, -np.inf):
            v = on
            for _ in range(40):
                v = np.nextafter(v, f32(direction))
                xs.append(v)
        xs += [rng.uniform(-30, 30, 50000).astype(f32),
               (rng.uniform(-1, 1, 50000)
                * 10.0 ** rng.uniform(-30, 10, 50000)).astype(f32),
               np.array([0.0, -0.0, 1e-45, -1e-45, np.inf, -np.inf, np.nan,
                         3e38, -3e38], f32)]
        xt = np.concatenate(xs)
        with np.errstate(all="ignore"):
            d = np.fmax(np.fmin((xt - cs).astype(f32), f32(16)), f32(-1))
            right = xt[:, None] < (pixels + cs).astype(f32)[None, :]
        first = np.minimum(np.floor(d).astype(np.int64) + 1, 16)
        np.testing.assert_array_equal(pixels[None, :] >= first[:, None],
                                      right)
