"""One run of one cell: set-up, the measured window, the output check,
and the result line."""

from __future__ import annotations

import gc
import subprocess
import sys
import time
import types
from collections import defaultdict

import numpy as np
import torch

from . import cells, compare, loops

BREAKDOWN_TOP = 10
NAME_CHARS = 96


def program_api():
    """The port's Scene API, as the scene generators take it."""
    import vello_tpu_torch as vt
    return types.SimpleNamespace(Scene=vt.Scene, kurbo=vt.kurbo,
                                 peniko=vt.peniko)


def scene_args(traffic) -> list:
    """The scene descriptions a mix draws."""
    return [dict(traffic.get("scene_args", {}))]


def params_of(config, RenderParams, render_mode="quality"):
    """The configuration's RenderParams of the port."""
    return RenderParams(int(config["width"]), int(config["height"]),
                        tuple(config["base_color"]), config["antialiasing"],
                        render_mode=render_mode)


def device_info(device: str, chips: int, peak: int) -> dict:
    """The result line's ``device``, with the card's power limit."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        power = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit": power}


class Run:
    """What the per-layer readers read: the set-up's host spans (name ->
    seconds each); the traced block (``trace.Trace`` or None); the host
    seconds of the window's frame calls and its wall ms per frame; and
    the bounds of one frame's kernel launches ({kernel: (launches, ms)})
    or None."""

    def __init__(self):
        self.spans = defaultdict(list)
        self.trace = None
        self.frame_ms = None
        self.enqueue_s = []
        self.bounds = None


def _breakdown(tr) -> dict:
    """The device's heaviest operations, and the idle gaps by the
    benchmark span the host was in, seconds over the traced block."""
    ops = sorted(((ns, name) for name, (ns, _) in tr.by_name().items()),
                 reverse=True)[:BREAKDOWN_TOP]
    gaps = sorted(((ns, name) for name, ns in tr.idle_gaps.items()),
                  reverse=True)[:BREAKDOWN_TOP]
    clean = (lambda s: "_".join(s.split())[:NAME_CHARS])
    return {"device_ops": [[clean(n), ns / 1e9] for ns, n in ops],
            "idle_gaps": [[n, ns / 1e9] for ns, n in gaps]}


def run(cell, args, device: str, overrides: dict, age, foreign):
    """The result dict of one run, or None when a forbidden module was
    loaded once the window closed."""
    config = dict(cell.config, **overrides.get("config", {}))
    traffic = dict(cell.traffic, **overrides.get("traffic", {}))
    gen = cell.scene_module()
    mode = "speed" if args.control == "speed" else "quality"
    rec = Run()

    # set-up: scenes from the seed, resolved; every frame warmed
    ages = [age()]
    import vello_tpu_torch as vt
    api = program_api()
    params = params_of(config, vt.RenderParams, mode)
    sargs = scene_args(traffic)
    scenes = []
    for a in sargs:
        t = time.perf_counter()
        scene = gen.build(api, config, args.seed, a)
        rec.spans["bench.encode"].append(time.perf_counter() - t)
        t = time.perf_counter()
        rs = vt.resolve(scene.encoding, params)
        rec.spans["bench.resolve"].append(time.perf_counter() - t)
        scenes.append((a, rs))
    ages.append(age())
    renderer = vt.Renderer(device=device)
    loop = loops.make(traffic, renderer, scenes, params, device, args.seed)
    loop.warm()
    setup_s = age()
    print(f"benchmark: set-up {setup_s:.2f} s: start to the cell "
          f"{ages[0]:.2f} s, port import and scenes {ages[1] - ages[0]:.2f}"
          f" s, first and warm frames {setup_s - ages[1]:.2f} s",
          file=sys.stderr)

    win = loop.run(args.seconds, bool(args.trace))
    if foreign():
        return None
    rec.trace, rec.frame_ms = win.trace, win.wall_s * 1e3 / win.frames
    rec.enqueue_s = win.enqueue_s
    if args.trace and device == "cuda":
        from . import roofline
        from vello_tpu_torch.ops import kernels
        rec.bounds = roofline.frame_bounds(kernels, loop.thunk)

    # the program's state goes before the reference runs
    kept, overflow_frames = win.kept, win.overflow_frames
    del loop, renderer, scenes
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    refs = compare.reference_frames(gen, config, sargs, args.seed, device)
    print(f"benchmark: reference {time.perf_counter() - t:.2f} s",
          file=sys.stderr)
    if args.control == "bf16":
        low = compare.reference_frames(gen, config, sargs, args.seed, device,
                                       dtype=torch.bfloat16)
        kept = [(k, low[k]) for k, _ in kept]
    nums = compare.numbers(kept, refs, overflow_frames)
    correct, checks = compare.verdict(nums, cell.limits, len(kept))

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cells.reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"frame_ms": rec.frame_ms,
               "frame_p95_ms": float(np.percentile(win.gaps_ms, 95)),
               "peak_gb": win.peak_bytes / 1e9,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    out = {"correct": bool(correct),
           "attempted": win.frames + win.traced_frames,
           "failed": overflow_frames, "metrics": metrics,
           "device": device_info(device, cell.chips, win.peak_bytes)}
    if args.trace and win.trace is not None:
        out["device"]["busy_s"] = win.trace.busy_ns / 1e9
        out["device"]["window_s"] = win.trace.window_ns / 1e9
        out["breakdown"] = _breakdown(win.trace)
    out["checks"] = checks
    return out
