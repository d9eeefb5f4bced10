"""Per-stage profile of the port's headline cells (counterpart of
``tools/profile_stages.py``): the host encode group, then the device time
of every pipeline stage of one frame, per path.

Usage: python -m vello_tpu_torch.tools.profile_stages [complexity] [size]

Builds ``filled_mmark(complexity, size)`` (defaults 10 and 1024, as the
JAX package's tool), times the scene build, the encoding's packed streams
and the host resolve, then renders the msaa16, area and msaa16_speed
(render_mode "speed") paths with ``Renderer.profile``: device ms per stage
(s01_tile_alloc ... s10_composite), "_other" and "_total", then, per host
range with device idle time, the idle ms and the host's CUDA runtime calls
(``utils.profile.idle_by_range``), on the GPU when one is available. On
the CPU there is no device trace, so each path's stages and idle split are
empty. The last line printed is one JSON object: {"encode": {"build_s",
"encode_streams_s", "resolve_s"}, "n_paths", "n_segs", "est_lines",
"size", "device", "paths": {path: {"stages_ms", "tier", "idle"}}}.
"""

from __future__ import annotations

import json
import sys
import time

import torch

# path -> (antialiasing, render_mode)
PATHS = {"msaa16": ("msaa16", "quality"), "area": ("area", "quality"),
         "msaa16_speed": ("msaa16", "speed")}
BASE = (0.1, 0.1, 0.1, 1.0)


def main(argv=None) -> dict:
    from vello_tpu_torch import Renderer, RenderParams, resolve
    from vello_tpu_torch.scenes.test_scenes import filled_mmark

    argv = sys.argv[1:] if argv is None else argv
    complexity = int(argv[0]) if len(argv) > 0 else 10
    size = int(argv[1]) if len(argv) > 1 else 1024
    device = "cuda" if torch.cuda.is_available() else "cpu"

    t0 = time.perf_counter()
    scene = filled_mmark(complexity, float(size))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene.encoding.packed_streams()
    encode_streams_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = resolve(scene.encoding, RenderParams(size, size, base_color=BASE))
    resolve_s = time.perf_counter() - t0
    out = {"encode": {"build_s": build_s,
                      "encode_streams_s": encode_streams_s,
                      "resolve_s": resolve_s},
           "n_paths": rs.n_paths, "n_segs": rs.n_segs,
           "est_lines": rs.est_lines, "size": size, "device": device,
           "paths": {}}
    print(f"filled_mmark-{complexity} {size}x{size} on {device}: build "
          f"{build_s:.4f} s, encode streams {encode_streams_s:.4f} s, "
          f"resolve {resolve_s:.4f} s", flush=True)
    for path, (aa, mode) in PATHS.items():
        params = RenderParams(size, size, base_color=BASE, antialiasing=aa,
                              render_mode=mode)
        r = Renderer(device=device)
        stages = r.profile(scene, params)
        idle = r.last_profile["idle"]
        out["paths"][path] = {"stages_ms": stages,
                              "tier": r.last_profile["tier"], "idle": idle}
        for name, ms in stages.items():
            print(f"{path:13s} {name:22s} {ms:10.4f} ms", flush=True)
        for name, v in sorted(idle.items(), key=lambda kv: -kv[1]["idle_ms"]):
            calls = ", ".join(f"{c} {ms:.4f}" for c, ms in sorted(
                v["runtime_ms"].items(), key=lambda kv: -kv[1]))
            print(f"{path:13s} idle in {name:22s} {v['idle_ms']:10.4f} ms; "
                  f"host {v['host_ms']:.4f} ms, runtime calls: {calls}",
                  flush=True)
        if not stages:
            print(f"{path:13s} (no device trace on the {device})",
                  flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
