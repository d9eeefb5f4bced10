"""The output check that decides ``correct``: the RGBA8 frames that the
timed path produced, held to the plain reference's frames of the same
scene descriptions.

The reference (``benchmark/reference``) builds each scene again from the
seed through its own frozen copy of the Scene API, encodes, decodes and
flattens it on the host (numpy), and rasterises it by point sampling with
its own float64 PyTorch code (``reference/raster.py``) on the same device.
It takes nothing the program made. The numbers compared, each against its
limit in ``limits/<cell>.json``:

- ``diff_share``: the share of the kept frames' u8 channel values that
  differ from the reference's (the worst frame);
- ``overflow_frames``: frames of the window whose overflow word was not
  0 (exact: limit 0)."""

from __future__ import annotations

import types

import torch


def reference_api():
    """The reference's Scene API, as the scene generators take it."""
    from . import reference as ref
    return types.SimpleNamespace(Scene=ref.Scene, kurbo=ref.kurbo,
                                 peniko=ref.peniko)


def reference_frames(gen, config, scene_args, seed, device,
                     dtype=torch.float64) -> list:
    """The reference's RGBA8 frame (numpy) of each scene description;
    ``dtype`` bfloat16 gives the control."""
    from . import reference as ref
    api = reference_api()
    return [ref.render_u8(gen.build(api, config, seed, a).encoding, config,
                          device, dtype).cpu().numpy() for a in scene_args]


def numbers(kept, refs, overflow_frames: int) -> dict:
    """The compared numbers of the kept frames against the reference's."""
    share = 0.0
    for k, img in kept:
        ref = refs[k]
        share = max(share, 1.0 if img.shape != ref.shape
                    else float((img != ref).mean()))
    return {"diff_share": share, "overflow_frames": overflow_frames}


def verdict(nums: dict, limits: dict, n_kept: int) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the compared numbers."""
    checks = {name: {"value": nums[name], "limit": limits[name]}
              for name in nums}
    ok = n_kept > 0 and all(c["value"] <= c["limit"]
                            for c in checks.values())
    return ok, checks
