"""The port's benchmark (counterpart of ``bench.py``): renders the
mmark-class scenes of ``bench.py`` through ``vello_tpu_torch`` and prints
ONE JSON line {metric, value, unit, vs_baseline, extra}.

    python -m vello_tpu_torch.bench [--cpu]

It runs the CUDA kernels on the GPU; ``--cpu`` runs every kernel's plain
PyTorch version on the CPU instead. Without ``--cpu`` and without a card
it raises: it never falls back to the CPU. It reads ``bench.py``'s
environment variables when ``main`` runs: BENCH_COMPLEXITY (30),
BENCH_SIZE (1600), BENCH_AA (msaa16), BENCH_ITERS (20), BENCH_BATCH (4),
BENCH_GENERAL (1) and BENCH_COLD (1).

The entries are ``bench.py``'s, at the headline's params (SIZE square,
AA, base (0.1, 0.1, 0.1, 1)), each timed as WARMUP frames then a loop of
frames with one sync at its end:
- the headline (``value``, fps): filled_mmark(COMPLEXITY, SIZE), u8 out,
  through ``get_pipeline`` on buffers packed once; vs_baseline = fps /
  177 (BASELINE.md); ``mlines_per_s`` from the host's line estimate;
- ``batched_fps``: BATCH frames per dispatch, as BATCH calls of
  ``render_frame`` on cloned buffers between two syncs (``bench.py``'s
  ``lax.map`` over stacked copies); ``batched`` holds its per-frame
  ``frame_ms`` and its ``launches`` over one batch;
- ``alt_fps``: area_quality and <AA>_speed on the headline's buffers,
  tier and live cap, each {fps, frame_ms, launches} or "error: ...";
- ``scenes`` (BENCH_GENERAL): stroked_mmark, gradient_image_mmark and
  layered_mmark through ``Renderer.render_resolved`` and its
  ``frame_thunk``, with ``bench.py``'s keys and ``caps``, the tier the
  frame ran at, or {"error": ...}.

Keys whose quantity differs from ``bench.py``'s carry other names:
``first_call_s`` (the headline's first frame; the port compiles nothing
per frame), ``build_s`` (wall time of ``kernels.build(force=True)``, every
source through nvcc, in a subprocess after the timed loops; null with
BENCH_COLD=0 or under ``--cpu``), ``kernels`` (the library and whether it
had to be built at start) and ``backend`` ("cuda" or "cpu"). New keys:
``device`` (the card's name, count and power limit) and ``launches``
beside each entry (the kernel wrappers' non-zero launch counts over the
entry's first frame, or first batch; none on the CPU, where no kernel
launches).
A frame that overflows after the headline's fallback prints an error line
and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
import time

import torch

from .encoding.config import RenderParams
from .encoding.resolve import resolve
from .models.renderer import (_TIER_KEYS, Renderer, pack_buffers,
                              paint_kinds, pipeline_static, to_torch)
from .ops import kernels
from .pipeline.render import get_pipeline, render_frame, wants_fused_geom
from .scenes import test_scenes

BASELINE_FPS = 177.0
BASE = (0.1, 0.1, 0.1, 1.0)
WARMUP = 2
BUILD_TIMEOUT = 1200.0
# the checkout's root, from which ``python -m vello_tpu_torch...`` runs
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_COLD_BUILD = """
import time
from vello_tpu_torch.ops import kernels
t0 = time.perf_counter()
kernels.build(force=True)
print(time.perf_counter() - t0)
"""


@dataclasses.dataclass(frozen=True)
class Settings:
    """``bench.py``'s knobs, with its defaults."""

    complexity: int = 30
    size: int = 1600
    aa: str = "msaa16"
    iters: int = 20
    batch: int = 4
    general: bool = True
    cold: bool = True

    @classmethod
    def from_env(cls) -> "Settings":
        env = os.environ.get
        return cls(complexity=int(env("BENCH_COMPLEXITY", "30")),
                   size=int(env("BENCH_SIZE", "1600")),
                   aa=env("BENCH_AA", "msaa16"),
                   iters=int(env("BENCH_ITERS", "20")),
                   batch=int(env("BENCH_BATCH", "4")),
                   general=env("BENCH_GENERAL", "1") != "0",
                   cold=env("BENCH_COLD", "1") != "0")

    @property
    def params(self) -> RenderParams:
        return RenderParams(self.size, self.size, base_color=BASE,
                            antialiasing=self.aa)


class Overflow(RuntimeError):
    """A frame's overflow word was not 0."""

    def __init__(self, flags: int):
        super().__init__(f"overflow {flags}")
        self.flags = flags


@dataclasses.dataclass
class Headline:
    """The headline frame, its inputs and its numbers."""

    rs: object
    caps: object
    params: RenderParams
    static: object
    bufs: dict
    img: torch.Tensor          # the first frame, (SIZE, SIZE, 4) u8
    encode_s: float
    first_call_s: float
    frame_ms: float
    launches: dict


def device_info(device: torch.device) -> dict:
    """What ran the frames: the card (name, count, power limit as
    nvidia-smi gives it), or the CPU."""
    if device.type == "cpu":
        return {"platform": "cpu",
                "name": platform.processor() or platform.machine(),
                "count": 1, "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        power = smi.rsplit(",", 1)[1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        power = None
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "power_limit": power}


def timed(frame, iters: int) -> float:
    """``frame`` () -> (image, overflow) run ``iters`` times back to back
    with one sync at the end: wall ms per frame. Raises Overflow if a
    frame overflowed."""
    overflows = []
    t0 = time.perf_counter()
    for _ in range(iters):
        overflows.append(frame()[1])
    int(overflows[-1])                   # the loop's one sync
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    flags = int(torch.stack([o.reshape(()) for o in overflows]).sum())
    if flags:
        raise Overflow(flags)
    return wall_ms


def counted(call):
    """(``call()``, the kernel wrappers' non-zero launch counts over
    it). An entry counts over its first frame, as ``chip_smoke.py``
    counts each path's."""
    kernels.reset_launches()
    out = call()
    return out, {k: v for k, v in kernels.launches.items() if v}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def headline(cfg: Settings, device: torch.device) -> Headline:
    """filled_mmark(COMPLEXITY, SIZE) in AA, u8 out, through get_pipeline
    on buffers packed and uploaded once, at the PipelineStatic the
    Renderer would build; on a live-fragment overflow it falls back to no
    culling, as ``bench.py`` does. Raises Overflow on any other."""
    _sync(device)                        # device init is not encode work
    t0 = time.perf_counter()
    scene = test_scenes.filled_mmark(cfg.complexity, float(cfg.size))
    params = cfg.params
    rs = resolve(scene.encoding, params)
    caps = rs.capacities(params)
    slim = wants_fused_geom()
    static = pipeline_static([rs], caps, params, fused_geom=slim)
    bufs = to_torch(pack_buffers(rs, caps, params, slim=slim,
                                 paint8=slim and paint_kinds([rs]) <= {0}),
                    device)
    _sync(device)
    encode_s = time.perf_counter() - t0
    fn = get_pipeline(static, u8_out=True)
    t0 = time.perf_counter()
    (img, overflow), launches = counted(lambda: fn(bufs))
    flags = int(overflow)
    first_call_s = time.perf_counter() - t0
    if flags and static.n_live:
        # the live-fragment bound overflowed: culling off (the Renderer
        # grows it in its retry loop; the bench keeps one static)
        static = dataclasses.replace(static, n_live=0)
        fn = get_pipeline(static, u8_out=True)
        (img, overflow), launches = counted(lambda: fn(bufs))
        flags = int(overflow)
    if flags:
        raise Overflow(flags)
    for _ in range(WARMUP):
        _, overflow = fn(bufs)
    int(overflow)
    frame_ms = timed(lambda: fn(bufs), cfg.iters)
    return Headline(rs, caps, params, static, bufs, img, encode_s,
                    first_call_s, frame_ms, launches)


def batched(head: Headline, cfg: Settings, device: torch.device):
    """BATCH frames per dispatch: (batched fps, the entry {batch,
    frame_ms per frame, launches over one batch}, the BATCH u8 frames of
    one batch)."""
    copies = [{k: v.clone() for k, v in head.bufs.items()}
              for _ in range(cfg.batch)]

    def run():
        outs = [render_frame(b, head.static, u8_out=True) for b in copies]
        return [img for img, _ in outs], sum(ovf for _, ovf in outs)

    (imgs, overflow), launches = counted(run)
    if int(overflow):
        raise Overflow(int(overflow))
    wall_ms = timed(run, max(cfg.iters // 2, 3))
    entry = {"batch": cfg.batch, "frame_ms": wall_ms / cfg.batch,
             "launches": launches}
    return cfg.batch * 1e3 / wall_ms, entry, imgs


def alt_entries(head: Headline, cfg: Settings, device: torch.device):
    """area_quality and <AA>_speed on the headline's buffers, tier and
    live cap: {name: {fps, frame_ms, launches} or "error: ..."}."""
    out = {}
    for aa, mode in (("area", "quality"), (cfg.aa, "speed")):
        name = f"{aa}_{mode}"
        try:
            params = dataclasses.replace(head.params, antialiasing=aa,
                                         render_mode=mode)
            static = pipeline_static([head.rs], head.caps, params,
                                     fused_geom=head.static.fused_geom,
                                     n_live=head.static.n_live)
            fn = get_pipeline(static, u8_out=True)
            (_, overflow), launches = counted(lambda: fn(head.bufs))
            flags = int(overflow)
            if flags:
                raise Overflow(flags)
            frame_ms = timed(lambda: fn(head.bufs), max(cfg.iters // 2, 3))
            out[name] = {"fps": 1e3 / frame_ms, "frame_ms": frame_ms,
                         "launches": launches}
        except Exception as e:           # recorded in the line, as bench.py
            out[name] = f"error: {str(e)[:80]}"
    return out


def scene_entry(builder, params: RenderParams, iters: int,
                device: torch.device) -> dict:
    """One general-path scene through the public Renderer (tier pick,
    overflow retry), then a warm loop of its frame thunk (no resolve, no
    readback)."""
    t0 = time.perf_counter()
    scene = builder()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = resolve(scene.encoding, params)
    resolve_s = time.perf_counter() - t0
    r = Renderer(device)
    t0 = time.perf_counter()
    _, launches = counted(
        lambda: r.render_resolved(rs, params, out="rgba8"))
    first_s = time.perf_counter() - t0
    thunk = r.frame_thunk()
    for _ in range(WARMUP):
        _, overflow = thunk()
    int(overflow)
    frame_ms = timed(thunk, iters)
    prof = r.last_profile
    return {"fps": 1e3 / frame_ms, "frame_ms": frame_ms,
            "launches": launches,
            "resolve_s": resolve_s, "first_frame_s": first_s,
            "n_paths": rs.n_paths, "n_segs": rs.n_segs,
            "est_lines": rs.est_lines, "retries": prof["retries"],
            "tier_lines": prof["tier"]["lines"],
            "tier_touches": prof["tier"]["touches"], "caps": prof["tier"],
            "build_s": build_s, "encode_s": build_s + resolve_s}


def scene_entries(cfg: Settings, device: torch.device) -> dict:
    """``bench.py``'s three general-path scenes at the headline's params:
    {name: entry or {"error": ...}}."""
    c, s = cfg.complexity, float(cfg.size)
    builders = {
        "stroked_mmark": lambda: test_scenes.mmark(c, s),
        "gradient_image_mmark": lambda: test_scenes.mixed_paint_mmark(c, s),
        "layered_mmark": lambda: test_scenes.layered_mmark(c, s)}
    out = {}
    for name, builder in builders.items():
        try:
            out[name] = scene_entry(builder, cfg.params,
                                    max(cfg.iters // 2, 5), device)
        except Exception as e:           # recorded in the line, as bench.py
            out[name] = {"error": str(e)[:200]}
    return out


def kernel_library(device: torch.device) -> dict:
    """The kernels' shared library, built now if it is older than its
    sources (so that no frame pays for nvcc); none on the CPU."""
    if device.type != "cuda":
        return {"lib": None, "built_at_start": False}
    before = (os.path.getmtime(kernels.LIB) if os.path.exists(kernels.LIB)
              else None)
    kernels.build()
    return {"lib": os.path.relpath(kernels.LIB, ROOT),
            "built_at_start": before != os.path.getmtime(kernels.LIB)}


def cold_build_s():
    """Wall time of ``kernels.build(force=True)`` in a subprocess (every
    source through nvcc anew; the library is replaced by a rename, so the
    one this process loaded stays valid), or None if it failed."""
    try:
        proc = subprocess.run([sys.executable, "-c", _COLD_BUILD], cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT)
        if proc.returncode == 0:
            return float(proc.stdout.strip().splitlines()[-1])
        print(f"bench: the forced build failed:\n{proc.stderr[-2000:]}",
              file=sys.stderr)
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        print(f"bench: the forced build failed: {e!r}", file=sys.stderr)
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run every kernel's plain PyTorch version on the "
                         "CPU")
    args = ap.parse_args(argv)
    cfg = Settings.from_env()
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("vello_tpu_torch.bench: no CUDA device is "
                           "available (--cpu runs the plain versions)")
    library = kernel_library(device)
    try:
        head = headline(cfg, device)
    except Overflow as e:
        print(json.dumps({"metric": "error", "value": -1, "unit": "",
                          "vs_baseline": 0, "note": str(e)}))
        raise SystemExit(1)
    fps = 1e3 / head.frame_ms
    batch_fps, batch = None, None
    if cfg.batch > 1:
        batch_fps, batch, _ = batched(head, cfg, device)
    alt = alt_entries(head, cfg, device)
    scenes = scene_entries(cfg, device) if cfg.general else {}
    # after the timed loops: nvcc does not share the host with a frame
    build_s = cold_build_s() if cfg.cold and device.type == "cuda" else None
    rs = head.rs
    print(json.dumps({
        "metric": f"fps filled_mmark-{cfg.complexity}k {cfg.size}x"
                  f"{cfg.size} {cfg.aa} ({rs.n_paths} paths, {rs.n_segs} "
                  f"segs, ~{rs.est_lines} lines)",
        "value": fps,
        "unit": "fps",
        "vs_baseline": fps / BASELINE_FPS,
        "extra": {
            "frame_ms": head.frame_ms,
            "launches": head.launches,
            "batched_fps": batch_fps,
            "batched": batch,
            "mlines_per_s": rs.est_lines * fps / 1e6,
            "alt_fps": alt,
            "first_call_s": head.first_call_s,
            "build_s": build_s,
            "kernels": library,
            "encode_s": head.encode_s,
            "scenes": scenes,
            "backend": device.type,
            "device": device_info(device),
            "caps": dict(zip(_TIER_KEYS, head.caps.key())),
        },
    }))


if __name__ == "__main__":
    main()
