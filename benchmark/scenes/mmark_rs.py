"""``mmark``: the stroke soup of vello's ``examples/scenes/src/mmark.rs``
(a frozen copy of ``vello_tpu_torch/scenes/test_scenes.py``'s ``mmark``).

A random walk over an 80 x 40 lattice of a 1600 x 900 canvas (offset 100
px down) gives the elements: lines, quads and cubics (seg types 0-1, 2,
3), elevated exactly to cubics. Each element ends its path with
probability 1/2. Each path is stroked at width u^5 * 20 + 1 in one of
mmark.rs's 7 opaque colors. The geometry comes from the configuration's
``geometry_seed`` and the colors from the run seed: every seed draws the
same paths in the same order, so it does the same work (the order of
opaque paths decides which fragments the port culls) and draws another
frame."""

import numpy as np

PALETTE = ((0x10, 0x10, 0x10), (0x80, 0x80, 0x80), (0xc0, 0xc0, 0xc0),
           (0x10, 0x10, 0x10), (0x80, 0x80, 0x80), (0xc0, 0xc0, 0xc0),
           (0xe0, 0x10, 0x40))
OFFSETS = ((-4, 0), (2, 0), (1, -2), (1, 2))


def _fold(v, m):
    v = np.abs(v) % (2 * m)
    return np.where(v > m, 2 * m - v, v)


def build(api, config: dict, seed: int, args: dict):
    n = int(config["elements"])
    gw, gh = config["grid"]
    scale = float(config["width"]) / 1600.0
    rng = np.random.default_rng(int(config["geometry_seed"]))
    s = api.Scene()
    sx = 1600.0 / (gw + 1) * scale
    sy = 900.0 / (gh + 1) * scale
    offs = np.asarray(OFFSETS, dtype=np.int64)
    walk = np.cumsum(offs[rng.integers(0, 4, size=2 * n + 4)], axis=0) \
        + np.array([gw // 2, gh // 2])
    chain = np.stack([(_fold(walk[:, 0], gw) + 0.5) * sx,
                      100.0 * scale + (_fold(walk[:, 1], gh) + 0.5) * sy],
                     axis=-1)
    i0 = 2 * np.arange(n)
    p0, pm, p1, pq = chain[i0], chain[i0 + 1], chain[i0 + 2], chain[i0 + 3]
    st = rng.integers(0, 4, size=n)
    is_line = (st < 2)[:, None]
    is_quad = (st == 2)[:, None]
    c1 = np.where(is_line, p0 + (p1 - p0) / 3.0,
                  np.where(is_quad, p0 + 2.0 / 3.0 * (pm - p0), pm))
    c2 = np.where(is_line, p0 + 2.0 / 3.0 * (p1 - p0),
                  np.where(is_quad, p1 + 2.0 / 3.0 * (pm - p1), pq))
    split = rng.random(n) < 0.5
    split[-1] = True
    first = np.concatenate([[True], split[:-1]])
    pid = np.cumsum(first) - 1
    n_paths = int(pid[-1]) + 1
    plen = np.bincount(pid, minlength=n_paths)
    widths = (rng.random(n_paths) ** 5 * 20.0 + 1.0) * scale
    pal = np.asarray(PALETTE, dtype=np.float32) / 255.0
    pick = np.random.default_rng(int(seed) % 2 ** 64).integers(
        0, 7, size=n_paths)
    cols = np.concatenate([pal[pick], np.ones((n_paths, 1), np.float32)],
                          axis=1)
    style = api.kurbo.Stroke(width=1.0, join=config["join"],
                             start_cap=config["cap"], end_cap=config["cap"])
    starts_of = np.concatenate([[0], np.cumsum(plen)[:-1]])
    kmax = int(plen.max())
    k = 1
    while True:
        sel = np.nonzero((plen > k // 2) & (plen <= k))[0] if k > 1 \
            else np.nonzero(plen == 1)[0]
        if len(sel):
            nb = len(sel)
            # each path's elements, padded to k by degenerate cubics at
            # the last element's endpoint
            eidx = starts_of[sel][:, None] + np.arange(k)[None, :]
            valid = np.arange(k)[None, :] < plen[sel][:, None]
            eidx = np.minimum(eidx, (starts_of[sel] + plen[sel] - 1)[:, None])
            pe = p1[eidx]
            pc1 = np.where(valid[..., None], c1[eidx], pe)
            pc2 = np.where(valid[..., None], c2[eidx], pe)
            trip = np.stack([pc1, pc2, pe], axis=2).reshape(nb, 3 * k, 2)
            pts = np.concatenate([p0[starts_of[sel]][:, None], trip], axis=1)
            s.stroke_batch(style, api.kurbo.Affine.identity(), cols[sel], pts,
                           widths=widths[sel])
        if k >= kmax:
            break
        k *= 2
    return s
