"""Runtime device probe: render a known mini-scene and byte-compare against
a stored reference to self-verify a backend at startup (the role of
``vello_common/src/probe.rs`` + ``assets/probe.rgba``)."""

from __future__ import annotations

import os

import numpy as np

from ..encoding.config import RenderParams
from ..kurbo import Affine, circle_path, rect_path
from ..peniko import Fill, palette
from ..scene import Scene

PROBE_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets", "probe.png")


def probe_scene() -> Scene:
    s = Scene()
    s.fill(Fill.NON_ZERO, Affine.identity(), palette.RED, None,
           rect_path(2, 2, 30, 30))
    s.fill(Fill.NON_ZERO, Affine.identity(), palette.LIME.with_alpha(0.5),
           None, circle_path(16, 16, 10))
    s.fill(Fill.EVEN_ODD, Affine.rotate_about(0.4, 16, 16), palette.BLUE,
           None, rect_path(8, 8, 24, 24))
    return s


PROBE_PARAMS = RenderParams(32, 32, base_color=(0, 0, 0, 1))


def run_probe(renderer=None, tolerance: int = 2) -> bool:
    """Render the probe scene and compare against the stored reference.
    Returns True when the device output matches within `tolerance` RGBA8
    levels per channel."""
    from ..utils.png import read_png, to_rgba8

    if renderer is None:
        from ..models.renderer import Renderer
        renderer = Renderer()
    img = to_rgba8(renderer.render(probe_scene(), PROBE_PARAMS))
    if not os.path.exists(PROBE_PATH):
        return False
    ref = read_png(PROBE_PATH)
    return bool((np.abs(ref.astype(int) - img.astype(int))
                 <= tolerance).all())


def regenerate_probe_reference(path: str) -> None:
    """Write the probe scene, as the CPU oracle (the ground truth) renders
    it, to the PNG ``path``. It takes no default: ``PROBE_PATH`` is the
    JAX package's stored reference, which the port reads and never
    writes."""
    from ..oracle import OracleRenderer
    from ..utils.png import write_png

    img = OracleRenderer().render(probe_scene(), PROBE_PARAMS)
    write_png(path, img)
