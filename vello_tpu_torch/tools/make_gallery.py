"""Render gallery PNGs on the port (counterpart of
``tools/make_gallery.py``), into a directory named on the command line.

Usage: python -m vello_tpu_torch.tools.make_gallery OUT_DIR [scene ...] [--cpu]
(default scene: filter_suite)

Each scene of ``vello_tpu_torch.scenes.test_scenes`` renders at its
default geometry to a 512x512 canvas (filter_suite 256x256) on a white
base, through ``Renderer.render_u8`` on the GPU, or with ``--cpu``
through ``Renderer(device="cpu")``; writes OUT_DIR/<scene>.png.
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("scenes", nargs="*", default=["filter_suite"])
    ap.add_argument("--cpu", action="store_true",
                    help="run the renderer on the CPU")
    args = ap.parse_args(argv)

    from vello_tpu_torch import Renderer, RenderParams
    from vello_tpu_torch.scenes import test_scenes as ts
    from vello_tpu_torch.utils.png import write_png

    os.makedirs(args.out_dir, exist_ok=True)
    r = Renderer(device="cpu" if args.cpu else "cuda")
    for name in args.scenes:
        scene = getattr(ts, name)()
        size = 512 if name != "filter_suite" else 256
        img = r.render_u8(scene, RenderParams(size, size,
                                              base_color=(1, 1, 1, 1)))
        out = os.path.join(args.out_dir, f"{name}.png")
        write_png(out, img)
        print("wrote", out)


if __name__ == "__main__":
    main()
