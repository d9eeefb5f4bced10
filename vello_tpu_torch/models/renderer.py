"""Public device Renderer (counterpart of ``vello_tpu/models/renderer.py``).

Resolve a Scene on the host, pick a capacity tier, pack the buffers to
its static shapes, run the frame on the device, and retry at a larger tier
when the overflow word comes back non-zero (the robust dynamic-memory loop
of ``vello::Renderer``).
"""

from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..encoding.config import Capacities, RenderParams, next_size
from ..encoding.resolve import PAINT_IMAGE, ResolvedScene, resolve
from ..pipeline import layered
from ..pipeline.render import (PipelineStatic, get_pipeline,
                               wants_fused_geom)
from ..scene import Scene
from ..utils.profile import profile_stages

# Attribute of a ResolvedScene under which the port caches its device
# tensors (the JAX Renderer caches jax arrays under ``_device_bufs``).
_CACHE_ATTR = "_torch_bufs"

_TIER_KEYS = ("tags", "points", "segs", "lines", "touches", "path_tiles",
              "paths", "transforms", "styles", "ramps", "edges")


def _pad(a: np.ndarray, n: int, fill=0):
    if len(a) >= n:
        return np.asarray(a[:n])
    pad_width = [(0, n - len(a))] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width, constant_values=fill)


def _path_tag_bounds(tags: np.ndarray, n_paths_cap: int,
                     n_tags_cap: int) -> np.ndarray:
    """(P+1,) i32 ascending slice boundaries: the position just after each
    path's TAG_PATH marker."""
    ends = np.nonzero((tags.astype(np.int64) & 0x10) != 0)[0] + 1
    bounds = np.concatenate([[0], ends]).astype(np.int32)
    out = np.full(n_paths_cap + 1, min(len(tags), n_tags_cap), np.int32)
    out[:min(len(bounds), n_paths_cap + 1)] = bounds[:n_paths_cap + 1]
    return out


def pack_buffers(rs: ResolvedScene, caps: Capacities, params: RenderParams,
                 slim: bool = False, paint8: bool = False) -> dict:
    """Pad resolved-scene arrays to the tier's static shapes (numpy).

    The same dict as the JAX package's ``pack_buffers``. ``slim`` keeps
    only what the fused geometry path reads; ``paint8`` (solid colors, no
    layers) cuts paint_pack to [kind, rgba premultiplied, 0, 0, 0]."""
    if paint8:
        paint_pack = np.concatenate([
            rs.paint_kind[:, None].astype(np.float32),
            rs.color, np.zeros((len(rs.color), 3), np.float32),
        ], axis=1)                                        # (P, 8)
    else:
        paint_pack = np.concatenate([
            rs.paint_kind[:, None].astype(np.float32),
            rs.color, rs.grad_rec, rs.paint_inv, rs.image_rec, rs.blur_rec,
            rs.path_kind[:, None].astype(np.float32),
        ], axis=1)                                        # (P, 40)
    out = {
        "fill_rule": _pad(rs.fill_rule, caps.n_paths),
        "path_kind": _pad(rs.path_kind, caps.n_paths),
        "path_rect": _pad(rs.path_rect, caps.n_paths),
        "paint_pack": _pad(paint_pack, caps.n_paths),
        "seg_pts": _pad(rs.seg_pts, caps.n_segs),
        "seg_path": _pad(rs.seg_path, caps.n_segs, fill=2 ** 24),
        "seg_kind": _pad(rs.seg_kind, caps.n_segs),
        "n_segs": np.asarray(min(len(rs.seg_kind), caps.n_segs),
                             dtype=np.int32),
        "n_tags_real": np.asarray(min(len(rs.tags), caps.n_tags),
                                  dtype=np.int32),
        "path_tag_bounds": _path_tag_bounds(rs.tags, caps.n_paths,
                                            caps.n_tags),
        "ramps": rs.ramps,
        "atlas": rs.atlas,
        "base_color": np.asarray(params.base_color, dtype=np.float32),
    }
    if rs.has_stroke:
        out["seg_hw"] = _pad(rs.seg_hw, caps.n_segs)
        out["seg_join"] = _pad(rs.seg_join, caps.n_segs)
        out["style_hw"] = _pad(rs.styles_hw, caps.n_styles)
    if not slim:
        out.update({
            "tags": _pad(rs.tags.astype(np.int32), caps.n_tags),
            "data": _pad(rs.data, caps.n_points),
            "transforms": _pad(rs.transforms, caps.n_transforms),
            "styles": _pad(rs.styles, caps.n_styles),
            "paint_kind": _pad(rs.paint_kind, caps.n_paths),
            "color": _pad(rs.color, caps.n_paths),
            "grad_rec": _pad(rs.grad_rec, caps.n_paths),
            "paint_inv": _pad(rs.paint_inv, caps.n_paths),
            "image_rec": _pad(rs.image_rec, caps.n_paths),
            "blur_rec": _pad(rs.blur_rec, caps.n_paths),
        })
    return out


def to_torch(bufs_np: dict, device) -> dict:
    """The packed numpy buffers as tensors on ``device`` (same dtypes and
    shapes; 0-d arrays stay 0-d)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in bufs_np.items()}


class Renderer:
    """Device renderer. ``render`` -> (H, W, 4) premultiplied f32 numpy;
    ``render_u8`` -> straight-alpha RGBA8.

    ``device`` is a torch device ("cpu" runs every kernel's plain PyTorch
    version; "cuda" runs the CUDA kernels and raises when there is no
    GPU). ``last_profile`` holds the tier, retries, live-fragment cap, the
    wall time of the last render up to its readback and the readback's
    time; ``profile`` gives the per-stage device time of a frame."""

    def __init__(self, device="cuda", max_retries: int = 3):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device='cuda'): no CUDA device is "
                               "available")
        self.max_retries = max_retries
        self.last_profile: dict = {}
        self._frame = None

    def frame_thunk(self):
        """The last successful frame as a closure over its cached device
        buffers: () -> (device image, overflow), with no host resolve and
        no readback. For benchmark and serving loops."""
        return self._frame

    def warmup(self, scene: Scene, params: RenderParams) -> None:
        """Render once and discard the image: builds the kernels and leaves
        the frame behind ``frame_thunk``."""
        self.render(scene, params)

    def profile(self, scene: Scene, params: RenderParams) -> dict:
        """Per-stage device time of the real frame, ms per frame: renders
        once, then traces three warm frames with torch.profiler and sums
        each kernel's time under its stage (``utils.profile``), plus
        "_total" and "_other". Returns {} when there is no device trace
        (a CPU renderer). Sets ``last_profile`` to {"stages", "tier"}, as
        the JAX Renderer does, and "kernels": {(stage, kernel name): ms}."""
        self.render(scene, params)
        tier = self.last_profile["tier"]
        stages, split, _ = (profile_stages(self._frame, detail=True)
                            if self.device.type == "cuda" else ({}, {}, {}))
        self.last_profile = {"stages": stages, "tier": tier,
                             "kernels": split}
        return stages

    def render(self, scene: Scene, params: RenderParams) -> np.ndarray:
        self._check_params(params)
        return self.render_resolved(resolve(scene.encoding, params), params)

    def render_u8(self, scene: Scene, params: RenderParams) -> np.ndarray:
        self._check_params(params)
        return self.render_resolved(resolve(scene.encoding, params), params,
                                    out="rgba8")

    @staticmethod
    def _check_params(params: RenderParams) -> None:
        if (params.antialiasing in ("msaa8", "msaa16")
                and os.environ.get("VELLO_TPU_SUPERSAMPLE_MSAA")):
            raise NotImplementedError(
                "the supersampled msaa path (VELLO_TPU_SUPERSAMPLE_MSAA) is "
                "not ported (ROADMAP: not ported unless a need appears)")

    def _device_bufs(self, rs: ResolvedScene, caps: Capacities,
                     params: RenderParams, slim: bool, paint8: bool) -> dict:
        key = (caps.key(), params.width, params.height,
               tuple(params.base_color), str(self.device), slim, paint8)
        cached = getattr(rs, _CACHE_ATTR, None)
        if cached is not None and cached[0] == key:
            return cached[1]
        bufs = to_torch(pack_buffers(rs, caps, params, slim=slim,
                                     paint8=paint8), self.device)
        object.__setattr__(rs, _CACHE_ATTR, (key, bufs))
        return bufs

    def render_resolved(self, rs: ResolvedScene, params: RenderParams,
                        out: str = "f32") -> np.ndarray:
        t_start = time.time()
        caps = rs.capacities(params)
        kinds = set(int(k) for k in rs.paint_kind)
        if PAINT_IMAGE in kinds:
            # the image sampling modes present, as 10 + quality markers
            quals = rs.image_rec[rs.paint_kind == PAINT_IMAGE, 6]
            kinds |= {10 + int(q) for q in set(quals.tolist())}
        has_layers = any(k in (3, 4) for k in rs.draw_kind)
        if has_layers:
            # the plan is host data, built once per resolved scene
            plan = layered.build_layer_plan(rs)[1]
            if "path_clipalpha" in plan:
                plan = dict(plan, path_clipalpha=torch.from_numpy(
                    plan["path_clipalpha"]).to(self.device))
        # VELLO_TPU_NO_FUSED_GEOM: the unfused geometry path, which reads
        # the tag and point streams (slim=False packs them); as in the JAX
        # package, those buffers keep the full paint_pack too
        slim = wants_fused_geom()
        # solid colors only: paint_pack shrinks to 8 columns (layers read
        # its column 39, the clip-path flag)
        paint8 = slim and kinds <= {0} and not has_layers
        kinds = tuple(sorted(kinds))
        # live-fragment cap: an exact host upper bound plus a small margin
        # for f32 tile-assignment jitter; bit 16 doubles it on a retry
        n_live = min(caps.n_path_tiles,
                     next_size(min(caps.n_path_tiles,
                                   rs.est_live + 64 + rs.n_paths // 16),
                               align=128))
        # even-odd specialization keys only the msaa resolve (as in the
        # JAX package, whose PipelineStatic is then the same)
        has_eo = True
        if params.antialiasing in ("msaa8", "msaa16"):
            has_eo = bool((rs.fill_rule == 1).any())
        has_edge = bool(rs.has_left_edge)
        overflow = 0
        for attempt in range(self.max_retries + 1):
            static = PipelineStatic(
                caps_key=caps.key(), width=params.width,
                height=params.height, kinds_present=kinds,
                aa=params.antialiasing, has_evenodd=has_eo,
                lowp=params.render_mode == "speed",
                n_live=0 if n_live >= caps.n_path_tiles else n_live,
                has_edge=has_edge, has_stroke=bool(rs.has_stroke),
                max_lines=int(rs.max_lines), fused_geom=slim)
            if has_layers:
                fn = layered.get_layered_pipeline(static, plan,
                                                  u8_out=(out == "rgba8"))
            else:
                fn = get_pipeline(static, u8_out=(out == "rgba8"))
            bufs = self._device_bufs(rs, caps, params, slim, paint8)
            frame = (lambda f=fn, b=bufs: f(b))
            self._frame = frame
            img, overflow_t = frame()
            overflow = int(overflow_t)           # the frame's one readback
            if overflow == 0:
                t_done = time.time()
                img = img.cpu().numpy()
                self.last_profile = {
                    "wall_s": t_done - t_start,
                    "readback_s": time.time() - t_done,
                    "tier": dict(zip(_TIER_KEYS, caps.key())),
                    "retries": attempt,
                    "layered": has_layers,
                    "n_live": static.n_live,
                    "est": {"lines": rs.est_lines,
                            "touches": rs.est_touches,
                            "path_tiles": rs.est_path_tiles},
                }
                return img
            # grow what overflowed (robust-memory retry)
            if overflow & 32:
                # the host hull test missed a left-edge crossing
                has_edge = True
            if overflow & 16:
                n_live *= 2
            caps = replace(
                caps,
                n_lines=caps.n_lines * (2 if overflow & 1 else 1),
                n_touches=caps.n_touches * (2 if overflow & 4 else 1),
                n_path_tiles=caps.n_path_tiles * (2 if overflow & 8 else 1),
                n_edges=caps.n_edges * (2 if overflow & 2 else 1))
        raise RuntimeError(f"render overflow persisted after "
                           f"{self.max_retries} retries (flags={overflow})")
