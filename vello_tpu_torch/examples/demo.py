"""Interactive demo + stats HUD on the port (counterpart of
``examples/demo.py``; the reference's examples/with_winit role:
frame loop, scene switching, and the stats overlay of stats.rs:20-125 —
fps, frame-time min/max, AA mode, capacity tier + retry readout, and a
bar graph of the frame-time sliding window — drawn INTO the scene and
rendered by the renderer itself).

Headless-interactive: renders an animated loop, writes frames (optionally
every frame for scrubbing), prints an fps-percentile JSON line at the end.

Usage:
  python -m vello_tpu_torch.examples.demo [--scene spin|orbits]
      [--aa area|msaa8|msaa16] [--frames N] [--size S] [--save-all DIR]
      [--cpu]

Runs on the GPU unless ``--cpu`` is given (``Renderer(device="cpu")``).
The HUD's text is drawn in the package's DejaVu Sans. The last frame goes to
``demo_last.png`` in the temporary directory.
"""
import argparse
import json
import math
import os
import tempfile
import time
from collections import deque

import numpy as np

from vello_tpu_torch import Affine, Fill, RenderParams, Scene
from vello_tpu_torch.kurbo import BezPath, circle_path, rect_path, star_path
from vello_tpu_torch.models.renderer import Renderer
from vello_tpu_torch.peniko import (Color, Extend, Gradient, palette,
                                    stops)
from vello_tpu_torch.utils.png import write_png

SLIDING_WINDOW = 100


class Stats:
    """Sliding-window frame statistics (stats.rs::Stats role)."""

    def __init__(self):
        self.samples = deque(maxlen=SLIDING_WINDOW)

    def add(self, dt_s: float):
        self.samples.append(dt_s * 1e3)

    def snapshot(self):
        if not self.samples:
            return dict(fps=0.0, ms=0.0, ms_min=0.0, ms_max=0.0,
                        ms_p90=0.0)
        a = np.asarray(self.samples)
        med = float(np.median(a))
        return dict(fps=1e3 / med if med else 0.0, ms=med,
                    ms_min=float(a.min()), ms_max=float(a.max()),
                    ms_p90=float(np.percentile(a, 90)))


def draw_hud(s: Scene, stats: Stats, profile: dict, vw: float, vh: float,
             aa: str):
    """Stats overlay drawn into the scene (stats.rs::Snapshot::draw_layer):
    translucent panel, text lines, and the frame-time bar graph."""
    from vello_tpu_torch.text import default_font, layout_text

    snap = stats.snapshot()
    w = min(max(vw * 0.42, 200.0), 600.0)
    h = w * 0.7
    x0, y0 = vw - w, vh - h
    s.fill(Fill.NON_ZERO, Affine.identity(),
           Color(0, 0, 0, 0.75), None, rect_path(x0, y0, vw, vh))
    tier = profile.get("tier", {})
    lines = [
        f"Frame Time: {snap['ms']:.2f} ms ({snap['fps']:.1f} fps)",
        f"Frame Time (min): {snap['ms_min']:.2f} ms",
        f"Frame Time (max): {snap['ms_max']:.2f} ms",
        f"Frame Time (p90): {snap['ms_p90']:.2f} ms",
        f"AA method: {aa}",
        f"Tier: lines={tier.get('lines')} touches={tier.get('touches')}",
        f"Retries: {profile.get('retries', 0)}",
    ]
    font = default_font()
    fs = max(h * 0.06, 9.0)
    ty = y0 + fs * 1.4
    for ln in lines:
        glyphs = layout_text(font, fs, ln, (x0 + w * 0.05, ty))
        s.draw_glyphs(font).font_size(fs).brush(palette.WHITE) \
            .draw(Fill.NON_ZERO, glyphs)
        ty += fs * 1.35
    # bar graph of the sliding window (stats.rs:105-140)
    if stats.samples:
        gx0, gy1 = x0 + w * 0.05, y0 + h * 0.95
        gw, gh = w * 0.9, h * 0.22
        a = np.asarray(stats.samples)
        top = max(float(a.max()), 1e-3)
        bw = gw / SLIDING_WINDOW
        bars = BezPath()
        for i, ms in enumerate(a):
            bh = gh * min(ms / top, 1.0)
            bx = gx0 + i * bw
            bars.move_to(bx, gy1 - bh)
            bars.line_to(bx + bw * 0.8, gy1 - bh)
            bars.line_to(bx + bw * 0.8, gy1)
            bars.line_to(bx, gy1)
            bars.close()
        s.fill(Fill.NON_ZERO, Affine.identity(),
               Color(0.2, 0.9, 0.5, 0.9), None, bars)


def scene_spin(t: float, size: float) -> Scene:
    s = Scene()
    g = Gradient.linear((0, 0), (size, size),
                        stops(palette.REBECCA_PURPLE, palette.GOLDENROD),
                        Extend.PAD)
    s.fill(Fill.NON_ZERO, Affine.identity(), g, None,
           circle_path(size / 2, size / 2, size * 0.47))
    s.fill(Fill.EVEN_ODD, Affine.rotate_about(t, size / 2, size / 2),
           Color(0.9, 0.25, 0.2, 0.85), None,
           star_path(size / 2, size / 2, 7, size * 0.16, size * 0.41))
    return s


def scene_orbits(t: float, size: float) -> Scene:
    s = Scene()
    s.fill(Fill.NON_ZERO, Affine.identity(), Color(0.05, 0.06, 0.1, 1),
           None, rect_path(0, 0, size, size))
    n = 24
    cx = cy = size / 2
    cols = [palette.CYAN, palette.MAGENTA, palette.GOLDENROD, palette.LIME]
    pts = []
    colors = []
    for i in range(n):
        ph = t * (0.4 + 0.03 * i) + i * 2 * math.pi / n
        r = size * (0.12 + 0.33 * i / n)
        x, y = cx + r * math.cos(ph), cy + r * math.sin(ph)
        # open 1-cubic centerline swinging with the orbit
        dx, dy = -math.sin(ph) * size * 0.06, math.cos(ph) * size * 0.06
        pts.append([[x - dx, y - dy], [x - dx / 3, y - dy / 3],
                    [x + dx / 3, y + dy / 3], [x + dx, y + dy]])
        c = cols[i % 4]
        colors.append([c.r, c.g, c.b, 0.9])
    from vello_tpu_torch.kurbo import Stroke
    s.stroke_batch(Stroke(width=max(size * 0.01, 2.0), join="bevel",
                          start_cap="butt", end_cap="butt"),
                   Affine.identity(), np.asarray(colors, np.float32),
                   np.asarray(pts, np.float32), expand="device")
    for i in range(n):
        p = pts[i][0]
        s.fill(Fill.NON_ZERO, Affine.identity(),
               cols[i % 4], None,
               circle_path(p[0], p[1], size * 0.015))
    return s


SCENES = {"spin": scene_spin, "orbits": scene_orbits}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="orbits", choices=sorted(SCENES))
    ap.add_argument("--aa", default="area",
                    choices=["area", "msaa8", "msaa16"])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--save-all", default=None,
                    help="directory: write every frame (scrub offline)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the renderer on the CPU")
    args = ap.parse_args(argv)

    make = SCENES[args.scene]
    size = float(args.size)
    params = RenderParams(args.size, args.size,
                          base_color=(0.05, 0.05, 0.08, 1.0),
                          antialiasing=args.aa)
    r = Renderer(device="cpu" if args.cpu else "cuda")
    stats = Stats()
    r.render_u8(make(0.0, size), params)   # builds the kernels (no HUD)
    img = None
    for k in range(args.frames):
        t0 = time.perf_counter()
        s = make(k * 0.12, size)
        draw_hud(s, stats, r.last_profile, size, size, args.aa)
        img = r.render_u8(s, params)
        stats.add(time.perf_counter() - t0)
        if args.save_all:
            os.makedirs(args.save_all, exist_ok=True)
            write_png(f"{args.save_all}/frame_{k:04d}.png", img)
    out = os.path.join(tempfile.gettempdir(), "demo_last.png")
    write_png(out, img)
    snap = stats.snapshot()
    print(json.dumps({"scene": args.scene, "aa": args.aa,
                      "frames": args.frames, "size": args.size,
                      **{k: round(v, 2) for k, v in snap.items()},
                      "out": out}))


if __name__ == "__main__":
    main()
