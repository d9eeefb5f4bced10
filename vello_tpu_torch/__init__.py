"""vello_tpu_torch — the vello_tpu renderer in PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper GPU.

The host side (Scene, encoding, resolver, capacity estimator) is this
package's own copy of ``vello_tpu``'s numpy/C++ host modules, with the same
module names; the device frame is PyTorch plus the kernels in ``csrc/``.
This package imports neither JAX nor ``vello_tpu``.

Supported: fills and device strokes with solid, gradient (linear, radial,
sweep), image (nearest, bilinear, bicubic) and blurred-rect paints; layers
(clips, group alpha, mix and compose modes, luminance and alpha masks,
layer filters); text (``Scene.draw_text`` / ``draw_glyphs``: outlines,
COLR v0/v1 and bitmap glyphs, hinted, raster and emboldened runs; fonts
are read by ``sfnt.py``, the default DejaVu Sans ships in
``assets/fonts/``; variable locations, COLR v1 and bitmap strikes need
fontTools, hinting PIL); area
(the default), centers, msaa8 or msaa16 antialiasing. A CPU tensor runs
each kernel's plain PyTorch version; a CUDA tensor runs the kernel (built
with ``nvcc`` at first use). The host side also holds the CPU oracle
(``oracle.OracleRenderer``), the reference scene corpus
(``scenes.reference_scenes``), an SVG loader (``utils.svg``), the device
probe (``utils.probe.run_probe``) and debug captures (``utils.debug``).
"""

from . import kurbo, peniko
from .encoding.config import RenderParams
from .encoding.resolve import ResolvedScene, resolve
from .kurbo import Affine, BezPath, Rect, Stroke
from .models.renderer import Renderer, pack_buffers, to_torch
from .peniko import BlendMode, Color, Compose, Extend, Fill, Gradient, \
    Image, Mix, palette
from .scene import Scene

__all__ = ["Affine", "BezPath", "BlendMode", "Color", "Compose", "Extend",
           "Fill", "Gradient", "Image", "Mix", "Rect", "RenderParams",
           "Renderer", "ResolvedScene", "Scene", "Stroke", "kurbo",
           "pack_buffers", "palette", "peniko", "resolve", "to_torch"]
