"""Structured logging (aux subsystem §5.5).

Env-gated so the hot path stays silent by default:
  VELLO_TPU_LOG=info|debug   enable; logs go to stderr via ``logging``.

Events logged: tier selection + overflow retries, pipeline compiles,
atlas evictions, layered-plan shapes. The role of the reference's
tracing/log usage (wgpu trace points + `log` crate calls).
"""

from __future__ import annotations

import logging
import os

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger("vello_tpu_torch")
        level = os.environ.get("VELLO_TPU_LOG", "").lower()
        if level in ("info", "debug", "1"):
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "[vello_tpu_torch %(levelname).1s] %(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.DEBUG if level == "debug" else logging.INFO)
        else:
            lg.addHandler(logging.NullHandler())
            lg.setLevel(logging.WARNING)
        _LOGGER = lg
    return _LOGGER
