"""Animated frame loop on the port (counterpart of
``examples/animation.py``): re-render a scene with a moving transform and
read back RGBA8, printing per-frame latency; writes the last frame to
``animation_last.png`` in the temporary directory.

Usage: python -m vello_tpu_torch.examples.animation [n_frames] [size] [--cpu]

Runs on the GPU unless ``--cpu`` is given (``Renderer(device="cpu")``).
"""

import argparse
import os
import tempfile
import time

import numpy as np

from vello_tpu_torch import Affine, Fill, RenderParams, Scene
from vello_tpu_torch.kurbo import circle_path, star_path
from vello_tpu_torch.peniko import Color, Extend, Gradient, palette, stops


def make_scene(t: float) -> Scene:
    """A gradient disc under an even-odd star turned by ``t`` radians.
    (``examples/animation.py`` asks the palette for GOLD, which it does
    not have, and stops there; the port takes GOLDENROD, as
    ``examples/demo.py`` does.)"""
    s = Scene()
    g = Gradient.linear((0, 0), (256, 256),
                        stops(palette.REBECCA_PURPLE, palette.GOLDENROD),
                        Extend.PAD)
    s.fill(Fill.NON_ZERO, Affine.identity(), g, None,
           circle_path(128, 128, 120))
    s.fill(Fill.EVEN_ODD, Affine.rotate_about(t, 128, 128),
           Color(0.9, 0.25, 0.2, 0.85), None,
           star_path(128, 128, 7, 40, 105))
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("n_frames", nargs="?", type=int, default=30)
    ap.add_argument("size", nargs="?", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="run the renderer on the CPU")
    args = ap.parse_args(argv)

    from vello_tpu_torch import Renderer
    from vello_tpu_torch.utils.png import write_png

    n, size = args.n_frames, args.size
    r = Renderer(device="cpu" if args.cpu else "cuda")
    params = RenderParams(size, size, base_color=(0.08, 0.08, 0.12, 1.0))
    r.render(make_scene(0.0), params)          # builds the kernels
    times = []
    img = None
    for k in range(n):
        t0 = time.perf_counter()
        img = r.render_u8(make_scene(k * 0.21), params)
        times.append(time.perf_counter() - t0)
    out = os.path.join(tempfile.gettempdir(), "animation_last.png")
    write_png(out, img)
    ms = np.asarray(times) * 1e3
    print(f"{n} frames @ {size}^2: median {np.median(ms):.1f} ms "
          f"({1e3 / np.median(ms):.1f} fps), p90 {np.percentile(ms, 90):.1f} ms"
          f" -> {out}")


if __name__ == "__main__":
    main()
