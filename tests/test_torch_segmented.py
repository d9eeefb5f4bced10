"""The port's ``ops/segmented.py`` and K8's plain version against the JAX
package, on the CPU.

- K8's plain version (``kernels.cumsum0_plain``) against the interpret-mode
  Pallas ``cumsum_pallas`` on (4096, 256) and (8192, 128): equal on values
  k/16 (every prefix is exact in f32, so every order of summation agrees);
  on uniform values within 2e-6 of the largest prefix (the Pallas kernel
  adds in f32 in its own order, the plain version rounds the exact prefix
  once);
- each segmented function against its JAX counterpart on seeded sorted ids
  with empty segments and a dump segment, under
  ``VELLO_TPU_PALLAS_INTERPRET=1``, so that the JAX ``_cumsum0`` runs its
  Pallas kernel on the (4096+, 256) f32 values: integer results and f32
  sums of k/16 values equal;
- the routing on the CPU: ``kernels.cumsum0`` takes its plain version and
  launches nothing; ``_cumsum0`` sends 2-D f32 tensors of any shape to it
  and everything else to ``torch.cumsum``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.ops import segmented as jax_segmented
from vello_tpu.ops.pallas_kernels import cumsum_pallas
from vello_tpu_torch.ops import kernels, segmented

N_SEG = 300          # segments 0 .. N_SEG - 1; id N_SEG is the dump segment


def _values(rng, shape, kind):
    if kind == "sixteenths":
        return (rng.integers(0, 17, shape) / 16.0).astype(np.float32)
    return rng.uniform(0.0, 1.0, shape).astype(np.float32)


def _sorted_ids(rng, n):
    """Ascending ids in [1, N_SEG]: segment 0 (a start of 0 that must read
    as 0), 5 and 6 are empty, and id N_SEG rows are dump rows."""
    allowed = np.setdiff1d(np.arange(1, N_SEG + 1), [5, 6])
    ids = np.sort(rng.choice(allowed, n)).astype(np.int32)
    assert ids[-1] == N_SEG
    return ids


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VELLO_TPU_PALLAS_INTERPRET", "1")


def _assert_equal(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K8's plain version

@pytest.mark.parametrize("kind", ["sixteenths", "uniform"])
@pytest.mark.parametrize("shape", [(4096, 256), (8192, 128)])
def test_cumsum_plain_matches_pallas(shape, kind):
    x = _values(np.random.default_rng(shape[1]), shape, kind)
    want = np.asarray(cumsum_pallas(jnp.asarray(x), interpret=True))
    got = kernels.cumsum0_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    if kind == "sixteenths":
        np.testing.assert_array_equal(got, want)
    else:
        bar = 2e-6 * np.abs(want).max()
        assert np.abs(got - want).max() <= bar


@pytest.mark.parametrize("shape", [(0, 5), (1, 1), (1, 256), (4097, 200),
                                   (300, 1)])
def test_cumsum_wrapper_on_cpu_takes_plain_version(shape):
    kernels.reset_launches()
    x = torch.from_numpy(_values(np.random.default_rng(1), shape, "uniform"))
    got = kernels.cumsum0(x)
    assert torch.equal(got, kernels.cumsum0_plain(x))
    assert torch.equal(got, torch.cumsum(x, 0))     # f64 accumulation
    assert kernels.launches["cumsum"] == 0


def test_cumsum0_routes_2d_f32_to_kernel(monkeypatch):
    calls = []
    original = kernels.cumsum0

    def spy(x):
        calls.append(tuple(x.shape))
        return original(x)
    monkeypatch.setattr(kernels, "cumsum0", spy)
    rng = np.random.default_rng(2)
    x2 = torch.from_numpy(_values(rng, (37, 3), "uniform"))
    assert torch.equal(segmented._cumsum0(x2), torch.cumsum(x2, 0))
    # a non-contiguous view goes in as a contiguous copy
    assert torch.equal(segmented._cumsum0(x2.T), torch.cumsum(x2.T, 0))
    assert calls == [(37, 3), (3, 37)]
    for other in (x2[:, 0], x2.to(torch.float64), x2.to(torch.int32),
                  x2.reshape(37, 3, 1)):
        assert torch.equal(segmented._cumsum0(other),
                           torch.cumsum(other, 0, dtype=other.dtype))
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the segmented functions

@pytest.mark.parametrize("case", ["f32_rows", "i32", "f32_3d", "f32_1d"])
def test_segment_sum_sorted_matches_jax(interpret, case):
    rng = np.random.default_rng(3)
    n = 4500 if case == "f32_rows" else 2000
    ids = _sorted_ids(rng, n)
    if case == "f32_rows":
        vals = _values(rng, (n, 256), "sixteenths")   # K8 on both sides
    elif case == "i32":
        vals = rng.integers(-50, 50, n).astype(np.int32)
    elif case == "f32_3d":
        vals = _values(rng, (n, 4, 8), "sixteenths")
    else:
        vals = _values(rng, n, "sixteenths")
    want = jax_segmented.segment_sum_sorted(jnp.asarray(vals),
                                            jnp.asarray(ids), N_SEG)
    got = segmented.segment_sum_sorted(torch.from_numpy(vals),
                                       torch.from_numpy(ids), N_SEG)
    assert got.dtype == torch.from_numpy(vals).dtype
    _assert_equal(got, want)
    assert not got[[0, 5, 6]].any()                  # empty segments


def test_segment_bounds_and_sums_from_bounds_match_jax():
    rng = np.random.default_rng(4)
    ids = _sorted_ids(rng, 3000)
    lo, hi = segmented.segment_bounds(torch.from_numpy(ids), N_SEG)
    jlo, jhi = jax_segmented.segment_bounds(jnp.asarray(ids), N_SEG)
    _assert_equal(lo, jlo)
    _assert_equal(hi, jhi)
    assert lo.dtype == hi.dtype == torch.int32
    for vals in (_values(rng, (3000, 16), "sixteenths"),
                 rng.integers(-9, 9, 3000).astype(np.int32)):
        got = segmented.segment_sum_from_bounds(torch.from_numpy(vals), lo,
                                                hi)
        _assert_equal(got, jax_segmented.segment_sum_from_bounds(
            jnp.asarray(vals), jlo, jhi))


def test_segment_ends_and_suffix_sums_match_jax(interpret):
    rng = np.random.default_rng(5)
    ids = _sorted_ids(rng, 4200)
    ends = segmented.segment_ends_sorted(torch.from_numpy(ids))
    _assert_equal(ends, jax_segmented.segment_ends_sorted(jnp.asarray(ids)))
    assert ends.dtype == torch.int32
    assert segmented.segment_ends_sorted(
        torch.zeros(0, dtype=torch.int32)).shape == (0,)
    vals = _values(rng, (4200, 256), "sixteenths")      # K8 on both sides
    got = segmented.segment_suffix_sum_sorted(torch.from_numpy(vals),
                                              torch.from_numpy(ids))
    _assert_equal(got, jax_segmented.segment_suffix_sum_sorted(
        jnp.asarray(vals), jnp.asarray(ids)))
    last = np.r_[ids[1:] != ids[:-1], True]
    assert not got[torch.from_numpy(last)].any()        # nothing after it


def test_row_prefix_sum_matches_jax():
    rng = np.random.default_rng(6)
    lens = rng.integers(1, 40, 120)
    row_start = np.repeat(np.cumsum(lens) - lens, lens).astype(np.int32)
    for vals in (_values(rng, int(lens.sum()), "sixteenths"),
                 rng.integers(-3, 4, int(lens.sum())).astype(np.int32)):
        got = segmented.row_prefix_sum(torch.from_numpy(vals),
                                       torch.from_numpy(row_start))
        _assert_equal(got, jax_segmented.row_prefix_sum(
            jnp.asarray(vals), jnp.asarray(row_start)))


def test_scatter_sum_via_sort_matches_jax():
    rng = np.random.default_rng(7)
    ids = rng.permutation(_sorted_ids(rng, 2500))
    for vals in (_values(rng, 2500, "sixteenths"),
                 rng.integers(-20, 20, 2500).astype(np.int32)):
        got = segmented.scatter_sum_via_sort(torch.from_numpy(vals),
                                             torch.from_numpy(ids), N_SEG)
        want = np.zeros(N_SEG, vals.dtype)
        keep = ids < N_SEG
        np.add.at(want, ids[keep], vals[keep])
        _assert_equal(got, want)
        _assert_equal(got, jax_segmented.scatter_sum_via_sort(
            jnp.asarray(vals), jnp.asarray(ids), N_SEG))
