"""Non-solid paints: the port's ``fine.eval_paints`` against the JAX
package's ``fine_xla.eval_paints``, and K6's plain version
(``fine.composite_src_plain``, exact sequential src-over) against the JAX
package's ``fine_composite_solid`` in interpret mode (a log/exp chunk
composite).

Each scene is resolved through the port (its host copy is equal to the JAX
package's, test_torch_host.py); every path's paint is then evaluated at
every tile of the 128x128 viewport by both packages on the same inputs.
Bars: premultiplied f32 within atol 1e-5 (the paint math rounds alike
except where XLA-CPU contracts a multiply-add); the composite within atol
2e-5, the bar of test_kernels_interp.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vello_tpu_torch as vt
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from test_torch_pipeline import (SIZE, blurred_rects, gradient_suite,
                                 image_quality)
from vello_tpu.ops import fine_xla
from vello_tpu.ops.pallas_kernels import FINE_CHUNK, NPX
from vello_tpu.ops.pallas_kernels import fine_composite_solid
from vello_tpu_torch import RenderParams, resolve
from vello_tpu_torch.encoding.resolve import PAINT_IMAGE
from vello_tpu_torch.ops import fine, kernels
from vello_tpu_torch.pipeline.render import occlusion_los


def gradient_grid(pkg):
    """Linear, radial and sweep gradients under PAD, REPEAT and REFLECT,
    a two-circle radial and a cone (circles not nested, so its valid mask
    has an edge), each filling the whole viewport. The REPEAT seams (t an
    integer) keep at least 0.2 px from every pixel center."""
    e, g, p = pkg.Extend, pkg.Gradient, pkg.palette
    st = pkg.peniko.stops(p.RED, p.YELLOW, p.BLUE)
    grads = []
    for ext in (e.PAD, e.REPEAT, e.REFLECT):
        grads += [g.linear((3.3, 0.0), (40.3, 0.0), st, ext),
                  g.linear((10.0, 7.0), (50.0, 37.0), st, ext),
                  g.radial((64.0, 60.0), 20.2, st, ext),
                  g.sweep((61.0, 67.0), 0.3, 2.5, st, ext)]
    grads += [g.radial((70.0, 70.0), 50.0, st, e.REFLECT,
                       center0=(55.0, 60.0), radius0=9.0),
              g.radial((90.0, 64.0), 30.0, st, e.PAD,
                       center0=(30.0, 64.0), radius0=10.0)]
    s = pkg.Scene()
    for grad in grads:
        s.fill(pkg.Fill.NON_ZERO, pkg.Affine.identity(), grad, None,
               pkg.kurbo.rect_path(0, 0, SIZE, SIZE))
    return s


SCENES = {"gradient_grid": gradient_grid, "gradient_suite": gradient_suite,
          "image_quality": image_quality, "blurred_rects": blurred_rects}


def paint_inputs(name):
    """(the eval_paints arguments as numpy, kinds_present): every path's
    paint at every tile of the viewport."""
    params = RenderParams(SIZE, SIZE)
    rs = resolve(SCENES[name](vt).encoding, params)
    kinds = set(int(k) for k in rs.paint_kind)
    if PAINT_IMAGE in kinds:
        quals = rs.image_rec[rs.paint_kind == PAINT_IMAGE, 6]
        kinds |= {10 + int(q) for q in set(quals.tolist())}
    nt = SIZE // 16
    path = np.repeat(np.arange(rs.n_paths), nt * nt)
    tile = np.tile(np.arange(nt * nt), rs.n_paths)
    args = [(tile % nt * 16).astype(np.float32),
            (tile // nt * 16).astype(np.float32),
            rs.paint_kind[path].astype(np.int32), rs.color[path],
            rs.grad_rec[path], rs.paint_inv[path], rs.image_rec[path],
            rs.blur_rec[path], rs.ramps, rs.atlas]
    return [np.ascontiguousarray(a) for a in args], kinds


@pytest.mark.parametrize("name", sorted(SCENES))
def test_eval_paints_matches_fine_xla(name):
    args, kinds = paint_inputs(name)
    ref = np.asarray(fine_xla.eval_paints(
        *(jnp.asarray(a) for a in args), frozenset(kinds)))
    got = fine.eval_paints(*(torch.from_numpy(a) for a in args),
                           frozenset(kinds))
    assert got.shape == ref.shape == (args[0].shape[0], 4, NPX)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    kind = args[2]
    if name == "image_quality":
        assert kinds == {2, 10, 11, 12}
    # the non-solid paints are in [0, 1] and not all empty
    rows = got.numpy()[kind != 0]
    assert rows.size and (rows[:, 3] > 0.05).any()
    assert rows.min() >= 0.0 and rows.max() <= 1.0


def test_gradient_grid_has_invalid_radial_region():
    """The cone's valid mask cuts the viewport: some pixels are 0."""
    args, kinds = paint_inputs("gradient_grid")
    got = fine.eval_paints(*(torch.from_numpy(a) for a in args),
                           frozenset(kinds)).numpy()
    cone = got[-64:]                        # the last path's 64 tiles
    assert (cone[:, 3] == 0).mean() > 0.05 and (cone[:, 3] > 0).mean() > 0.05


def _src_stream(rng, n_frag, n_gtiles, opaque_frac):
    """Sorted fragments with premultiplied per-pixel src rows; some rows
    opaque and fully covering."""
    g = np.sort(rng.integers(0, n_gtiles, n_frag)).astype(np.int32)
    a = rng.uniform(0.0, 1.0, (n_frag, 1, NPX)).astype(np.float32)
    opaque = rng.uniform(size=n_frag) < opaque_frac
    a[opaque] = 1.0
    rgb = rng.uniform(0.0, 1.0, (n_frag, 3, NPX)).astype(np.float32) * a
    return g, np.concatenate([rgb, a], axis=1), opaque


@pytest.mark.parametrize("n_frag,n_gtiles", [(FINE_CHUNK * 3, 37), (64, 5)])
@pytest.mark.parametrize("occlusion", [False, True])
def test_composite_src_plain_matches_pallas(n_frag, n_gtiles, occlusion):
    rng = np.random.default_rng(3)
    g, src, opaque = _src_stream(rng, n_frag, n_gtiles,
                                 0.3 if occlusion else 0.0)
    base = np.array([0.05, 0.1, 0.2, 1.0], np.float32)
    starts = torch.from_numpy(np.searchsorted(
        g, np.arange(n_gtiles + 1), side="left").astype(np.int32))
    tsrc = torch.from_numpy(src)
    if occlusion:
        cov = torch.from_numpy(np.where(opaque[:, None], 1.0, 0.5)
                               .astype(np.float32)).expand(n_frag, NPX)
        los, his = occlusion_los(torch.from_numpy(g), cov,
                                 torch.from_numpy(opaque), n_gtiles, starts)
        assert (los > starts[:-1]).any()       # some walks were advanced
    else:
        los, his = starts[:-1], starts[1:]
    ref = fine_composite_solid(
        jnp.asarray(src), jnp.asarray(base),
        (jnp.asarray(los.numpy()), jnp.asarray(his.numpy())), n_gtiles,
        interpret=True)
    got = kernels.composite_src(tsrc, torch.from_numpy(base), los, his)
    assert kernels.launches["composite_src"] == 0   # the plain version ran
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
    if occlusion:
        # an opaque full cover overwrites dst exactly, so skipping what
        # lies below it changes nothing
        full = fine.composite_src_plain(tsrc, torch.from_numpy(base),
                                        starts[:-1], starts[1:])
        np.testing.assert_array_equal(got.numpy(), full.numpy())


def test_composite_src_is_solid_composite_of_col_times_cov():
    """K6 on src = col x cov equals K4 on (cov, col) up to the rounding of
    the product."""
    rng = np.random.default_rng(4)
    f, n_gtiles = 200, 9
    g = np.sort(rng.integers(0, n_gtiles, f))
    cov = torch.from_numpy(rng.uniform(0, 1, (f, NPX)).astype(np.float32))
    a = rng.uniform(0, 1, (f, 1))
    col = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 1, (f, 3)) * a, a], axis=1).astype(np.float32))
    base = torch.tensor([0.1, 0.2, 0.3, 1.0])
    starts = torch.from_numpy(np.searchsorted(
        g, np.arange(n_gtiles + 1)).astype(np.int32))
    los, his = starts[:-1], starts[1:]
    src = col[:, :, None] * cov[:, None, :]
    np.testing.assert_allclose(
        kernels.composite_src(src, base, los, his).numpy(),
        kernels.composite_solid(cov, col, base, los, his).numpy(),
        rtol=0, atol=1e-6)
