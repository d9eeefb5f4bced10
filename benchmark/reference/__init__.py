"""The benchmark's plain reference, which decides ``correct``: a frozen
copy of the port's scene encoder (Scene, kurbo, peniko, the encoding
streams) and of its numpy host decode and flatten, and a rasteriser of
its own (``raster.py``: point sampling and a source-over fold in
float64 PyTorch) that shares nothing with the port's pipeline. It
imports nothing of ``vello_tpu_torch``, JAX or ``vello_tpu``. Later
changes to the port do not reach it."""

from . import kurbo, peniko
from .frame import render_u8
from .scene import Scene

__all__ = ["Scene", "kurbo", "peniko", "render_u8"]
