"""K4's plain version (the port's exact sequential src-over) against the
JAX package's ``fine_composite_solid_cov`` in interpret mode (a log/exp
chunk composite), at its bar of atol 2e-5, with and without the
occlusion-advanced walk from the port's ``occlusion_los``; and the plain
version of the occlusion walk's starts against the JAX package's
``occlusion_los`` and a reverse walk per tile, on ``occlusion_cases``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import occlusion_cases
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu.ops.pallas_kernels import FINE_CHUNK, NPX
from vello_tpu.ops.pallas_kernels import fine_composite_solid_cov
from vello_tpu.pipeline import render as jax_render
from vello_tpu_torch.ops import kernels
from vello_tpu_torch.pipeline.render import occlusion_los

OCCLUSION_CASES = occlusion_cases.cases()


def _frag_stream(rng, n_frag, n_gtiles, opaque_frac):
    g = np.sort(rng.integers(0, n_gtiles, n_frag)).astype(np.int32)
    cov = rng.uniform(0.0, 1.0, (n_frag, NPX)).astype(np.float32)
    a = rng.uniform(0.0, 1.0, (n_frag, 1)).astype(np.float32)
    opaque = rng.uniform(size=n_frag) < opaque_frac
    a[opaque] = 1.0
    cov[opaque & (rng.uniform(size=n_frag) < 0.7)] = 1.0
    col = np.concatenate([rng.uniform(0, 1, (n_frag, 3)) * a, a],
                         axis=1).astype(np.float32)
    return g, cov, col


@pytest.mark.parametrize("n_frag,n_gtiles", [(FINE_CHUNK * 3, 37), (64, 5)])
@pytest.mark.parametrize("occlusion", [False, True])
def test_composite_plain_matches_pallas(n_frag, n_gtiles, occlusion):
    rng = np.random.default_rng(7)
    g, cov, col = _frag_stream(rng, n_frag, n_gtiles,
                               0.3 if occlusion else 0.0)
    base = np.array([0.05, 0.1, 0.2, 1.0], np.float32)
    starts = np.searchsorted(g, np.arange(n_gtiles + 1),
                             side="left").astype(np.int32)
    tg, tcov, tcol = (torch.from_numpy(v) for v in (g, cov, col))
    tstarts = torch.from_numpy(starts)
    if occlusion:
        opaque = tcol[:, 3] >= 1.0 - 1e-6
        los, his = occlusion_los(tg, tcov, opaque, n_gtiles, tstarts)
        assert (los > tstarts[:-1]).any()      # some walks were advanced
    else:
        los, his = tstarts[:-1], tstarts[1:]
    ref = fine_composite_solid_cov(
        jnp.asarray(cov), jnp.asarray(col), jnp.asarray(base),
        (jnp.asarray(los.numpy()), jnp.asarray(his.numpy())), n_gtiles,
        interpret=True)
    got = kernels.composite_solid(tcov, tcol, torch.from_numpy(base), los,
                                  his)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
    if occlusion:
        # an opaque full cover overwrites dst exactly, so skipping what
        # lies below it changes nothing
        full = kernels.composite_solid(tcov, tcol, torch.from_numpy(base),
                                       tstarts[:-1], tstarts[1:])
        np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.mark.parametrize("case", sorted(OCCLUSION_CASES))
def test_occlusion_los_plain_matches_jax_and_a_walk(case):
    """The plain starts equal a reverse walk per tile and the JAX
    package's cummax (which also masks g_s < n_loc; its gather fails on
    no fragments), through ``render.occlusion_los`` and the wrapper."""
    g_s, cov, opaque, n_loc, starts = OCCLUSION_CASES[case]
    t = [torch.from_numpy(v) for v in (g_s, cov, opaque, starts)]
    los, his = occlusion_los(t[0], t[1], t[2], n_loc, t[3])
    kernels.reset_launches()
    direct = kernels.occlusion_los(t[1], t[2], t[3])
    assert kernels.launches["occlusion_los"] == 0     # CPU: plain
    assert los.dtype == direct.dtype == torch.int32
    np.testing.assert_array_equal(los.numpy(), direct.numpy())
    np.testing.assert_array_equal(his.numpy(), starts[1:])
    np.testing.assert_array_equal(
        los.numpy(), occlusion_cases.walk(cov, opaque, starts))
    if len(g_s):
        jlos, jhis = jax_render.occlusion_los(
            jnp.asarray(g_s), jnp.asarray(cov), jnp.asarray(opaque), n_loc,
            jnp.asarray(starts))
        np.testing.assert_array_equal(los.numpy(), np.asarray(jlos))
        np.testing.assert_array_equal(his.numpy(), np.asarray(jhis))


def test_full_cover_threshold_is_torchs():
    """FULL_COVER_F32, the kernel's threshold, splits the f32 neighbours
    as torch's ``>= FULL_COVER`` on an f32 tensor does."""
    thr = np.float32(kernels.FULL_COVER_F32)
    x = torch.tensor([np.nextafter(thr, np.float32(0)), thr,
                      np.nextafter(thr, np.float32(2))])
    assert (x >= kernels.FULL_COVER).tolist() == [False, True, True]
    assert (x >= kernels.FULL_COVER_F32).tolist() == [False, True, True]
    assert thr == occlusion_cases.THR
