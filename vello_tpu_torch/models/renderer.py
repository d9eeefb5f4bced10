"""Public device Renderer (counterpart of ``vello_tpu/models/renderer.py``).

Resolve a Scene on the host, pick a capacity tier, pack the buffers to
its static shapes, run the frame on the device, and retry at a larger tier
when the overflow word comes back non-zero (the robust dynamic-memory loop
of ``vello::Renderer``).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import replace

import numpy as np
import torch

from ..encoding.config import Capacities, RenderParams, next_size
from ..encoding.resolve import PAINT_IMAGE, ResolvedScene, resolve
from ..kurbo import Affine
from ..pipeline import layered
from ..pipeline.render import (PipelineStatic, get_pipeline,
                               wants_fused_geom)
from ..scene import Scene
from ..utils.profile import Span, frame_span, profile_stages

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


def paint_kinds(resolved) -> set:
    """The paint kinds of the scenes, with the image sampling modes
    present as 10 + their quality markers."""
    kinds = set()
    for rs in resolved:
        k = set(int(v) for v in rs.paint_kind)
        if PAINT_IMAGE in k:
            quals = rs.image_rec[rs.paint_kind == PAINT_IMAGE, 6]
            k |= {10 + int(q) for q in set(quals.tolist())}
        kinds |= k
    return kinds


def live_cap(resolved, caps: Capacities, est_live=None) -> int:
    """The live-fragment cap of the scenes at ``caps``: an exact host upper
    bound (``est_live``, else the scenes' largest estimate) plus a small
    margin for f32 tile-assignment jitter."""
    if est_live is None:
        est_live = max(rs.est_live for rs in resolved)
    n_paths = max(rs.n_paths for rs in resolved)
    return min(caps.n_path_tiles,
               next_size(min(caps.n_path_tiles,
                             est_live + 64 + n_paths // 16), align=128))


def pipeline_static(resolved, caps: Capacities, params: RenderParams, *,
                    fused_geom: bool, n_live=None,
                    has_edge=None) -> PipelineStatic:
    """The PipelineStatic of one or more resolved scenes rendered at one
    shared ``caps``: their paint kinds, fill rules, strokes and flatten
    cap. ``n_live`` (default ``live_cap``) and ``has_edge`` (default the
    scenes' left-edge test) are what a retry grows."""
    if n_live is None:
        n_live = live_cap(resolved, caps)
    if has_edge is None:
        has_edge = any(bool(rs.has_left_edge) for rs in resolved)
    # even-odd specialization keys only the msaa resolve (as in the JAX
    # package, whose PipelineStatic is then the same)
    has_eo = (params.antialiasing not in ("msaa8", "msaa16")
              or any(bool((rs.fill_rule == 1).any()) for rs in resolved))
    return PipelineStatic(
        caps_key=caps.key(), width=params.width, height=params.height,
        kinds_present=tuple(sorted(paint_kinds(resolved))),
        aa=params.antialiasing, has_evenodd=has_eo,
        lowp=params.render_mode == "speed",
        n_live=0 if n_live >= caps.n_path_tiles else n_live,
        has_edge=has_edge,
        has_stroke=any(bool(rs.has_stroke) for rs in resolved),
        max_lines=max(int(rs.max_lines) for rs in resolved),
        fused_geom=fused_geom)


def frame_call(fn, bufs: dict, cuda: bool):
    """The frame that ``Renderer.frame_thunk`` hands out: () -> ``fn(bufs)``,
    inside ``vt.frame`` (``utils.profile.frame_span``; ``cuda``: its
    synchronisations counted) while a profiler records, else after one
    flag test."""
    def frame():
        if torch.autograd._profiler_enabled():
            with frame_span(cuda):
                return fn(bufs)
        return fn(bufs)
    return frame


def to_torch(bufs_np: dict, device) -> dict:
    """The packed numpy buffers as tensors on ``device`` (same dtypes and
    shapes; 0-d arrays stay 0-d)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in bufs_np.items()}


def rgba8_device(img: torch.Tensor) -> torch.Tensor:
    """Premultiplied f32 (H, W, 4) -> straight-alpha RGBA8 on the image's
    device: the ops of ``utils.png.to_rgba8`` in its order, so the bytes
    equal its result on the same f32 image (rgb 0 where alpha quantizes
    to 0)."""
    a = img[..., 3:4].clamp(0.0, 1.0)
    vis = a >= 1.0 / 510.0
    safe = torch.where(vis, a, 1.0)
    rgb = torch.where(vis, (img[..., :3] / safe).clamp(0.0, 1.0), 0.0)
    return (torch.cat([rgb, a], dim=-1) * 255.0 + 0.5).to(torch.uint8)


def supersample_factor(params: RenderParams) -> int:
    """k of the supersampled msaa path: 3 for msaa8, 4 for msaa16."""
    return 3 if params.antialiasing == "msaa8" else 4


def supersampled_scene(scene: Scene, params: RenderParams):
    """(the scene scaled by k, its "centers" RenderParams at k*W x k*H):
    the frame the supersampled msaa path renders."""
    k = supersample_factor(params)
    up = Scene()
    up.append(scene, Affine.scale(float(k)))
    return up, RenderParams(params.width * k, params.height * k,
                            params.base_color, "centers")


def box_resolve(img: torch.Tensor, height: int, width: int,
                k: int) -> torch.Tensor:
    """The k x k box resolve of a (k*height, k*width, 4) supersampled frame
    to (height, width, 4), on its device."""
    img = img[:height * k, :width * k]
    return img.reshape(height, k, width, k, 4).mean(dim=(1, 3))


class Renderer:
    """Device renderer. ``render`` -> (H, W, 4) premultiplied f32 numpy;
    ``render_u8`` -> straight-alpha RGBA8.

    ``device`` is a torch device ("cpu" runs every kernel's plain PyTorch
    version; "cuda" runs the CUDA kernels and raises when there is no
    GPU). ``last_profile`` holds the tier, retries, live-fragment cap, and
    the host spans of the last render (``utils.profile.Span``): its wall
    time up to the readback (``wall_s``), the readback's (``readback_s``),
    and within the first, the packing and upload of its buffers
    (``upload_s``), its frames on freshly uploaded buffers up to their
    overflow reads (``first_frame_s``) and the kernel library's load
    (``kernels_load_s``), each 0.0 where the render had none; ``profile``
    gives the per-stage device time of a frame."""

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
        the JAX Renderer does, "kernels": {(stage, kernel name): ms} and
        "idle": the device's idle ms and the host's CUDA runtime calls per
        frame under each host range (``utils.profile.idle_by_range``).
        As the JAX method, it renders ``params`` as given, whatever
        VELLO_TPU_SUPERSAMPLE_MSAA says."""
        self.render_resolved(resolve(scene.encoding, params), params)
        tier = self.last_profile["tier"]
        stages, split, _, idle = (
            profile_stages(self._frame, detail=True)
            if self.device.type == "cuda" else ({}, {}, {}, {}))
        self.last_profile = {"stages": stages, "tier": tier,
                             "kernels": split, "idle": idle}
        return stages

    def _use_supersample(self, params: RenderParams) -> bool:
        """msaa8/msaa16 run through the sample-mask pipeline (per-sample
        winding at the D3D standard positions, K3);
        VELLO_TPU_SUPERSAMPLE_MSAA=1, read at call time, selects k*k
        supersampling instead. 'centers' is the supersampled frame's own
        mode and renders directly."""
        return (params.antialiasing in ("msaa8", "msaa16")
                and bool(os.environ.get("VELLO_TPU_SUPERSAMPLE_MSAA")))

    def render(self, scene: Scene, params: RenderParams) -> np.ndarray:
        if self._use_supersample(params):
            return self._render_supersampled(scene, params)
        return self.render_resolved(resolve(scene.encoding, params), params)

    def render_u8(self, scene: Scene, params: RenderParams) -> np.ndarray:
        if self._use_supersample(params):
            return self._render_supersampled(scene, params, out="rgba8")
        return self.render_resolved(resolve(scene.encoding, params), params,
                                    out="rgba8")

    def _render_supersampled(self, scene: Scene, params: RenderParams,
                             out: str = "f32") -> np.ndarray:
        """msaa8/msaa16 as 3x/4x supersampling: the encoding scaled by k,
        a "centers" frame at k*W x k*H (each pixel's area coverage
        thresholded at 0.5, so a path covers a pixel wholly or not at all
        and the frame composites per sample), then a k x k box resolve.
        k*k is at least the mode's sample count.

        Two differences of form from the JAX package's method, not of
        function: the crop and the k x k mean run on the device and only
        the (H, W, 4) result is read back (the JAX package reads back the
        k*W x k*H f32 frame and resolves it in numpy: 655 MB at 6400^2);
        and ``out="rgba8"`` applies ``utils.png.to_rgba8``'s rounding on
        the device to the resolved frame (``rgba8_device``), where the
        pipeline's u8 output would convert before the resolve.
        ``frame_thunk`` then re-runs the centers frame, and
        ``last_profile`` holds its tier and retries."""
        up, big = supersampled_scene(scene, params)
        rs = resolve(up.encoding, big)
        with Span("vt.render") as render:
            img = self._render_device(rs, big)
            img = box_resolve(img, params.height, params.width,
                              supersample_factor(params))
            if out == "rgba8":
                img = rgba8_device(img)
        return self._read_back(img, render)

    def _device_bufs(self, rs: ResolvedScene, caps: Capacities,
                     params: RenderParams, slim: bool, paint8: bool):
        """(the scene's buffers on the device, whether they were packed
        and uploaded now, in ``vt.upload``, rather than cached)."""
        key = (caps.key(), params.width, params.height,
               tuple(params.base_color), str(self.device), slim, paint8)
        cached = getattr(rs, _CACHE_ATTR, None)
        if cached is not None and cached[0] == key:
            return cached[1], False
        with Span("vt.upload"):
            bufs = to_torch(pack_buffers(rs, caps, params, slim=slim,
                                         paint8=paint8), self.device)
        object.__setattr__(rs, _CACHE_ATTR, (key, bufs))
        return bufs, True

    def render_resolved(self, rs: ResolvedScene, params: RenderParams,
                        out: str = "f32") -> np.ndarray:
        with Span("vt.render") as render:
            img = self._render_device(rs, params, out)
        return self._read_back(img, render)

    def _read_back(self, img: torch.Tensor, render: Span) -> np.ndarray:
        """The image to the host; ``last_profile`` gets the spans of the
        render (``render``, up to the readback) and of the readback."""
        with Span("vt.readback") as readback:
            out = img.cpu().numpy()
        self.last_profile.update(
            wall_s=render.seconds, readback_s=readback.seconds,
            upload_s=render.within("vt.upload"),
            first_frame_s=render.within("vt.first_frame"),
            kernels_load_s=render.within("vt.kernels_load"))
        return out

    def _render_device(self, rs: ResolvedScene, params: RenderParams,
                       out: str = "f32") -> torch.Tensor:
        """The frame on the device, retried until its overflow word is 0:
        the image tensor; sets ``last_profile`` and the frame thunk."""
        caps = rs.capacities(params)
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
        paint8 = slim and paint_kinds([rs]) <= {0} and not has_layers
        # bit 16 doubles the live-fragment cap on a retry
        n_live = live_cap([rs], caps)
        has_edge = bool(rs.has_left_edge)
        cuda = self.device.type == "cuda"
        overflow = 0
        for attempt in range(self.max_retries + 1):
            static = pipeline_static([rs], caps, params, fused_geom=slim,
                                     n_live=n_live, has_edge=has_edge)
            if has_layers:
                fn = layered.get_layered_pipeline(static, plan,
                                                  u8_out=(out == "rgba8"))
            else:
                fn = get_pipeline(static, u8_out=(out == "rgba8"))
            bufs, uploaded = self._device_bufs(rs, caps, params, slim,
                                               paint8)
            frame = frame_call(fn, bufs, cuda)
            self._frame = frame
            # a frame on new buffers, with the kernels' load on first use
            with (Span("vt.first_frame") if uploaded
                  else contextlib.nullcontext()):
                img, overflow_t = frame()
                overflow = int(overflow_t)       # the frame's one readback
            if overflow == 0:
                self.last_profile = {
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
