"""The reference's rasteriser on shapes whose coverage is known, and its
threaded host flatten against the serial one."""

import json
import os

import numpy as np
import torch

from benchmark import compare
from benchmark.reference import frame, raster
from benchmark.reference.encoding.encoding import decode_segments
from benchmark.reference.encoding.host_flatten import flatten_decoded
from benchmark.scenes import mmark_rs
from benchmark.tests.conftest import ROOT, TINY


def _rect(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1),
            (x0, y1, x0, y0)]


def test_known_coverage():
    """A rectangle from (2, 1) to (6.5, 3): full pixels, a column half
    covered (the 8 of msaa16's 16 samples left of x + 0.5), and a second
    rectangle over part of it, later in draw order, in even-odd with a
    hole."""
    lines = _rect(2, 1, 6.5, 3) + _rect(4, 0, 8, 4) + _rect(5, 1, 7, 3)
    path = [0] * 4 + [1] * 8
    color = [(1.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.5, 0.5)]
    img = raster.render_u8(lines, path, [0, 1], color, [0, 1],
                           (0.0, 0.0, 0.0, 1.0), "msaa16", 10, 5, "cpu")
    img = img.numpy().astype(int)
    assert (img[1:3, 2:4] == [255, 0, 0, 255]).all()
    assert (img[1:3, 6] == [128, 0, 0, 255]).all()      # half of 255
    # blue at alpha 0.5 over red, and over the base in the hole's frame
    assert (img[1:3, 4] == [128, 0, 128, 255]).all()
    assert (img[0, 4:8] == [0, 0, 128, 255]).all()
    assert (img[1:3, 5:7, 2] == 0).all()                 # the hole
    assert (img[:, 0] == [0, 0, 0, 255]).all()


def test_threaded_flatten_equals_serial():
    cfg = dict(json.load(open(os.path.join(ROOT, "benchmark/configs/"
                                           "mmark.json"))), **TINY["mmark"])
    enc = mmark_rs.build(compare.reference_api(), cfg, 3, {}).encoding
    tags, data, transforms, styles = enc.packed_streams()
    dec = decode_segments(tags, data, transforms, styles,
                          style_hw=enc.style_hw_array())
    a, b = flatten_decoded(dec), frame.flatten(dec)
    assert len(a[0]) > 1000
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_bf16_fold_differs():
    lines = _rect(0, 0, 8, 8)
    args = ([0] * 4, [0], [(0.3, 0.6, 0.9, 1.0)], [0],
            (0.1, 0.1, 0.1, 1.0), "msaa16", 8, 8, "cpu")
    lines_half = [(x0 + 0.3, y0, x1 + 0.3, y1) for x0, y0, x1, y1 in lines]
    hi = raster.render_u8(lines_half, *args)
    lo = raster.render_u8(lines_half, *args, dtype=torch.bfloat16)
    assert (hi != lo).any()
