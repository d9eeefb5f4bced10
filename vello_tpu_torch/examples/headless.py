"""Headless renderer CLI on the port (counterpart of
``examples/headless.py``): render a corpus scene (or an SVG file) to PNG
with the device renderer or the CPU oracle.

Usage:
  python -m vello_tpu_torch.examples.headless splash out.png
  python -m vello_tpu_torch.examples.headless tiger out.png --size 512
  python -m vello_tpu_torch.examples.headless file.svg out.png --renderer oracle
  python -m vello_tpu_torch.examples.headless --list

The device renderer runs on the GPU unless ``--cpu`` is given, which runs
every kernel's plain PyTorch version (``Renderer(device="cpu")``).
"""

import argparse
import time


def scene_table():
    """name -> function(size) building each scene the CLI renders."""
    from vello_tpu_torch.scenes import test_scenes as ts
    scenes = dict(ts.DEVICE_SCENES)
    scenes.update(ts.LAYER_SCENES)
    scenes["tiger"] = ts.tiger
    scenes["mmark"] = ts.mmark
    scenes["filled_mmark"] = ts.filled_mmark
    scenes["text_heavy"] = ts.text_heavy
    return scenes


def load_svg_scene(path: str, size: int, fit: bool):
    """An SVG file as a scene; with ``fit`` its viewBox scaled to fill a
    ``size`` canvas."""
    import xml.etree.ElementTree as ET

    from vello_tpu_torch.kurbo import Affine
    from vello_tpu_torch.utils.svg import load_svg
    t = Affine.IDENTITY
    if fit:
        root = ET.parse(path).getroot()
        vb = root.get("viewBox")
        if vb:
            x0, y0, w, h = (float(v) for v in vb.replace(",", " ").split())
        else:
            x0 = y0 = 0.0
            w = float((root.get("width") or "512").rstrip("px"))
            h = float((root.get("height") or "512").rstrip("px"))
        k = size / max(w, h)
        t = Affine.scale(k) @ Affine.translate(-x0, -y0)
    return load_svg(path, transform=t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", help="scene name or .svg path")
    ap.add_argument("--fit", action="store_true",
                    help="scale an SVG's viewBox to fill the canvas")
    ap.add_argument("out", nargs="?", default="out.png")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--renderer", choices=["device", "oracle"],
                    default="device")
    ap.add_argument("--base-color", default="0.05,0.05,0.05,1")
    ap.add_argument("--cpu", action="store_true",
                    help="run the device renderer on the CPU")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    all_scenes = scene_table()
    if args.list or not args.scene:
        print("scenes:", ", ".join(sorted(all_scenes)))
        return

    from vello_tpu_torch import RenderParams
    from vello_tpu_torch.utils.png import write_png

    base = tuple(float(v) for v in args.base_color.split(","))
    params = RenderParams(args.size, args.size, base_color=base)

    t0 = time.time()
    if args.scene.endswith(".svg"):
        scene = load_svg_scene(args.scene, args.size, args.fit)
    else:
        scene = all_scenes[args.scene](float(args.size))
    t_build = time.time() - t0

    t0 = time.time()
    if args.renderer == "oracle":
        from vello_tpu_torch.oracle import OracleRenderer
        img = OracleRenderer().render(scene, params)
    else:
        from vello_tpu_torch import Renderer
        img = Renderer(device="cpu" if args.cpu else "cuda").render(
            scene, params)
    t_render = time.time() - t0

    write_png(args.out, img)
    print(f"{args.scene}: {scene.encoding.n_paths} paths, "
          f"{scene.encoding.n_path_segments} segs; build {t_build:.2f}s, "
          f"render {t_render:.2f}s ({args.renderer}) -> {args.out}")


if __name__ == "__main__":
    main()
