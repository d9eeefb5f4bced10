"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --text      # phase 9 alone (builds if needed)

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compile the port's CUDA kernels from vello_tpu_torch/csrc (one
     nvcc per source, all at once), and print what ptxas reports for each
     kernel: registers, shared memory, spills;
  3. the twelve frame paths at full size, 1600x1600 through
     vello_tpu_torch.Renderer(device="cuda").render_u8, each with the
     launch counts set to 0 just before it and read just after:
     a. msaa16: filled_mmark-30k (kernels K1 flatten, K2 touch expansion,
        K3 msaa coverage, K4 solid composite);
     b. area, the default antialiasing: filled_mmark-30k (K1, K2, K5 area
        coverage, K4);
     c. gradient_image: mixed_paint_mmark-30k in msaa16, 20% of its fills
        gradients and bilinear images (K1, K2, K3, the paint evaluation,
        K6 src composite);
     d. stroked: mmark-30k in msaa16, device strokes (K1 with its stroke
        rows, K2, K3, K4);
     e. layered: layered_mmark-30k in msaa16, 24 alpha/blend groups
        through the layered compositor (K1, K2, K3, K7 once per draws op
        with a non-empty path range, the pops);
     f. layered_unrolled: blend_grid (16 cells, 15 of them clipped blend
        layers) in msaa16 with VELLO_TPU_UNROLLED_LAYERS=1, the unrolled
        formulation (K1, K2, K3, K7 per draws op, K8 column cumsum once per
        clipped push); its frame must equal, byte for byte, the scan
        formulation's frame of the same scene (msaa clip coverage prefixes
        are exact in f32);
     g. msaa16_speed: filled_mmark-30k in msaa16 with render_mode "speed"
        (the bench's msaa16_speed cell: colors rounded to bf16 into K4;
        K1, K2, K3, K4);
     h. gradient_image_speed: mixed_paint_mmark-30k, speed (K1, K2, K3,
        K6's bf16 instantiation on bf16 src rows);
     i. layered_speed: layered_mmark-30k, speed (K1, K2, K3, K7's bf16
        instantiation once per non-empty draws op);
     j. centers: filled_mmark-30k in "centers" antialiasing, the area
        coverage of each pixel thresholded at 0.5 (K1, K2, K5 with its
        centers epilogue, K4);
     k. msaa16_supersampled: the same scene in msaa16 with
        VELLO_TPU_SUPERSAMPLE_MSAA=1: the scene scaled by 4, a 6400x6400
        centers frame (K1, K2, K5 centers, K4), then the 4x4 box resolve
        and the u8 conversion on the card; its tier, Renderer.profile and
        kernels are the centers frame's;
     l. msaa8_supersampled: the same in msaa8, a 4800x4800 centers frame
        and a 3x3 resolve;
     each with overflow 0, no retry, the host's tier and one launch of each
     of its kernels (the fused paths' segment preparation before K1 too,
     and every flat path's occlusion walk before K4 or K6; K7: as many as
     the plan's non-empty draws ops; K8: as many as its
     clipped pushes); first-frame and warm per-frame times, peak memory;
     Renderer.profile's device ms per stage, held to cover all but 5% of
     the device time with each kernel under its stage (K1 and the segment
     preparation under s02_flatten, K2 under s03_touch_expand, ...), and
     each kernel's in-frame time per launch; the stage ranges' host cost;
     then the supersampled msaa16 frame (f32) within SAMPLE_MASK_MEAN mean
     abs of the sample-mask msaa16 frame of the same scene, and its
     render_u8 bytes equal to utils.png.to_rgba8 of its f32 frame;
  4. each kernel against its plain PyTorch version on the inputs of the
     path named for it in KERNELS (K1 twice: on the fill rows of the msaa16
     frame and on the stroke rows of the stroked frame; K2 twice: on the
     msaa16 and the stroked frame's inputs; K3 three times: on those two
     and, as msaa_coverage_mmark, on the benchmark cell mmark.resident's
     (benchmark/scenes/mmark_rs.py's scene at its configuration, 1600x900
     msaa16, one frame), each with the rows that take each of its paths
     (msaa_row_paths); K7 on the layered
     frame's largest draws op, a clone of its buffer for each run, since
     it works in place; the bf16 instantiations of K6 on the
     gradient_image_speed frame's inputs and of K7 on the layered_speed
     frame's largest draws op, each equal to its plain version, its bytes
     bound counting src at 2 bytes; K8 twice: on the unrolled frame's
     largest clipped push, and on a seeded (n_live, 256) input at the
     layered cell's live tier, uniform and in multiples of 1/16; K1, K2, K5
     and K4 once more on each of the three centers paths' inputs, the
     <kernel>_<path> entries, K5 with its centers threshold and bit-equal;
     the segment preparation before K1 (segment_prep: its two kernels and
     the torch.cumsum between them) twice, on the msaa16 frame's fill-only
     segments and the stroked frame's, its pack and count scan bit-equal to
     its plain version's, bound by bytes alone; the occlusion walk's starts
     (occlusion_los_<path>) on the msaa16, stroked and gradient_image
     frames' inputs, bit-equal, bound by bytes alone: the opaque rows of
     each [los, his), their flags, the ranges and los), with times for
     both (CUDA events, and the kernel's profiled time), the least time
     the card could take and, for K8, torch.cumsum's time, for the
     occlusion walk its plain version's (the amin and cummax chain that
     the frame ran before) and how often the walk engages (the share of
     tiles with a full opaque cover, of live rows below one); the synced
     warm ms of those frames and of the layered one, which bypasses the
     walk; the paint evaluation's time on the gradient frame's inputs;
  5. 512x512 frames of all twelve paths' scenes (speed and centers
     included; the supersampled paths on filled_mmark(1, 128.) at
     128x128, also held within 2.5e-3 mean abs of the port's oracle), and
     of a scene with every
     kind of layer (clip chain, pushed clip, luminance and alpha masks,
     multiply, blur filter, unbalanced push), rendered on the GPU and with
     the port on the CPU, within 1 u8 level;
  6. the device probe (utils/probe.run_probe on the GPU Renderer against
     assets/probe.png, within 2 levels), then the repository's golden
     corpus: each ported reference scene (scenes/reference_scenes.py) but
     the three that draw text in Roboto, which the repository does not
     hold, through Renderer(device="cuda").render in area AA at its golden
     size and base color (CORPUS_SIZES, the SIZES of
     tests/test_reference_goldens.py), with overflow 0, no retry, the
     host's tier and its kernels' launches (K1, K2, K5 once; K4 for solid
     paints only, else K6, once; or K7 once per non-empty draws op of a
     layered scene), held to the bars of that test: mean abs within
     2.5e-3 of the port's CPU oracle (all but many_draw_objects, whose 90k
     paths take the oracle minutes) and, against tests/snapshots/
     ref_<name>.png, RGBA8 mean < 0.002 and max < 4.01/255
     (tests/snapshot.py); first-frame s, warm ms over 5 frames and device
     ms per scene, and the phase's time. The three Roboto scenes stay
     out because the font is not in the repository (text is phase 9);
  7. the mesh (vello_tpu_torch/parallel/mesh.py), its ranks spawned on the
     one card after the build (parallel/launch.run_ranks, a timeout on each
     world): gloo ranks on cuda:0 render at 1600x1600 (a) filled_mmark-30k
     in msaa16 at dp=2 x sp=2, two seeds, through MeshRenderer; (b) the
     same in area at sp=2 (K5's raw entry, held on rank 0's inputs equal
     to its plain version: the kernels line's coverage_area_raw); (c)
     mixed_paint_mmark-30k in msaa16 at sp=2 (K6); (d) layered_mmark-30k
     in msaa16 at sp=2 through build_sharded_renderer with its scan_key
     (K7 per stripe); then one dp=1 x sp=1 frame on NCCL. Each rank: the
     shared host tier, no retry, overflow 0, its launches (the segment
     preparation and K1 once, on the rank's tag slots; K2 1, K3 or K5-raw
     1, K4 or K6 1, K7 once per non-empty draws op), the wall
     ms of warm frames, device ms (by stage on rank 0) and peak memory,
     which are not a scaling figure (the ranks share one card, and gloo
     stages its all-reduces through the host); each stitched frame within
     1 u8 level of Renderer(device="cuda")'s frame of the scene (msaa:
     byte-identical expected; the differing bytes are printed);
  8. the port's bench, ``python -m vello_tpu_torch.bench`` at its defaults
     (bench.py's: filled_mmark-30k at 1600x1600 in msaa16; batched B=4;
     area_quality and msaa16_speed; stroked_mmark, gradient_image_mmark
     and layered_mmark; the forced nvcc build) in a subprocess with a
     timeout of its own (BENCH_TIMEOUT), whose JSON line is printed again
     before the card's line. It fails on a non-zero exit, no line, an
     "error" metric, an "error: ..." alt entry, a scene's error or retry,
     a missing build_s, or launches that differ from phase 3's for the
     matching path (BENCH_PATHS; the
     batched entry's: B times the msaa16 path's). Its frame_ms beside
     phase 3's warm median is printed, not held: the frames are
     host-bound;
  9. text, drawn from the repository's fonts only
     (vello_tpu_torch/assets/fonts/, read by vello_tpu_torch/sfnt.py):
     the script runs itself with ``--text`` in
     a subprocess (TEXT_TIMEOUT; its failure fails the run) that prints
     whether fontTools, matplotlib and PIL import on this host, then sets
     sys.modules[name] = None for the three before it imports the port.
     Through Renderer(device="cuda").render at 1024x1024 (the
     TEXT_CELLS): (a) text_heavy at its defaults (40 lines of 14 px white
     on the base, area: K1 fill rows, K2, K5, K4; its occlusion walk held
     equal to its plain version, with its time, bound, the plain
     version's time and how often it engages); (b) the same in msaa16
     (K1, K2, K3, K4); (c) text_scene(1024.) (its gradient run through
     eval_paints and K6: K1, K2, K5, K6); (d) glyph_runs, accented text
     (composite glyphs) filled, stroked (Stroke(width=1.5, join="round"):
     Scene.stroke expands it into fills on the host, so K1 takes fill
     rows) and emboldened (K1, K2, K5, K4), and glyph_raster,
     runs through the glyph atlas (image paints: K1, K2, K5, K6); (e)
     color_glyphs, an emoji picker (PICKERS: a DejaVu header over 8 x 6
     glyphs at 96 px) from vello_tpu_torch/assets/fonts/test/
     ColrV1Paints.ttf, COLR v1 paint graphs read by sfnt.py, their clip
     and blend layers through the layered compositor (K1, K2, K5, K7 once
     per non-empty draws op; its largest op held equal to its plain
     version, its launches' profiled ms beside the sum of their bounds;
     the pushes, pops and the pops' device ms), and (f) bitmap_glyphs,
     the same grid from the CBDT and the sbix font (their PNGs decoded by
     utils/png.py; image rects: K1, K2, K5, K6, its call held equal to
     its plain version). Each
     with overflow 0, no retry, the host's tier and its launches (counts
     reset just before the first frame, read just after); build s and
     resolve s of the scene (outlines parsed on the host), first-frame s,
     warm ms (median of 20), Renderer.profile's device ms by stage (held
     as in phase 3), device ms, busy share and peak GB; the frame within
     2.5e-3 mean abs of the port's oracle (b: within SAMPLE_MASK_MEAN of
     the oracle's msaa16, which supersamples on a 4x4 grid where the
     device takes the 16-sample mask), the oracle frames rendered after
     the timed ones, in parallel worker processes (spawned, refusing the
     font packages too). Then 512x512 versions of the
     seven (text_heavy at lines=20) within 1 u8 level of the port's CPU
     frame,
     and text_scene(128.) against tests/snapshots/text_scene.png with the
     bars of tests/snapshot.py (RGBA8 mean < 0.002, max < 4.01/255), on
     the base color of tests/test_torch_text.py. It fails if a font
     package was loaded.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels, the one before that the card, and the one before that the
bench's line. ``--profile DIR`` also writes a torch.profiler table of
three warm frames of each path to DIR, and prints phase 3's per-path
numbers once more as one JSON line {"phase3": {path: {...}}} before the
bench's line (and to
DIR/phase3_summary.json), so that they stay in the output's tail.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

SIZE = 1600
COMPLEXITY = 30
BASE = (0.1, 0.1, 0.1, 1.0)
WARM_FRAMES = 20

# Published H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): HBM3
# bandwidth and f32 rate outside the tensor cores. The kernels are f32
# scalar code, so the f32 rate is the operations bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the least the card reads from HBM at once (an L2 sector)
DRAM_SECTOR_BYTES = 32

# entry of the kernels line -> (launch counter, wrapper, plain version,
# CUDA source, the TPU kernel it replaces, the path whose inputs it is
# held and timed on)
KERNELS = {
    "flatten": ("flatten", "flatten_lines", "flatten_lines_plain",
                "vello_tpu_torch/csrc/flatten.cu",
                "vello_tpu/ops/pallas_kernels.py:711", "msaa16"),
    "flatten_stroke_rows": ("flatten", "flatten_lines",
                            "flatten_lines_plain",
                            "vello_tpu_torch/csrc/flatten.cu",
                            "vello_tpu/ops/pallas_kernels.py:711",
                            "stroked"),
    "expand_touches": ("expand_touches", "expand_touches",
                       "expand_touches_plain",
                       "vello_tpu_torch/csrc/expand_touches.cu",
                       "vello_tpu/ops/pallas_kernels.py:911", "msaa16"),
    "expand_touches_stroked": ("expand_touches", "expand_touches",
                               "expand_touches_plain",
                               "vello_tpu_torch/csrc/expand_touches.cu",
                               "vello_tpu/ops/pallas_kernels.py:911",
                               "stroked"),
    "msaa_coverage": ("msaa_coverage", "msaa_coverage",
                      "msaa_coverage_plain",
                      "vello_tpu_torch/csrc/msaa_coverage.cu",
                      "vello_tpu/ops/pallas_kernels.py:349", "msaa16"),
    "msaa_coverage_stroked": ("msaa_coverage", "msaa_coverage",
                              "msaa_coverage_plain",
                              "vello_tpu_torch/csrc/msaa_coverage.cu",
                              "vello_tpu/ops/pallas_kernels.py:349",
                              "stroked"),
    # the benchmark cell's inputs (capture_cell_msaa); held beside the
    # stroked path's, whose launches it shares
    "msaa_coverage_mmark": ("msaa_coverage", "msaa_coverage",
                            "msaa_coverage_plain",
                            "vello_tpu_torch/csrc/msaa_coverage.cu",
                            "vello_tpu/ops/pallas_kernels.py:349",
                            "stroked"),
    "composite_solid": ("composite_solid", "composite_solid",
                        "composite_solid_plain",
                        "vello_tpu_torch/csrc/composite_solid.cu",
                        "vello_tpu/ops/pallas_kernels.py:1303", "msaa16"),
    "coverage_area": ("coverage_area", "coverage_area",
                      "coverage_area_plain",
                      "vello_tpu_torch/csrc/coverage_area.cu",
                      "vello_tpu/ops/pallas_kernels.py:84", "area"),
    "composite_src": ("composite_src", "composite_src",
                      "composite_src_plain",
                      "vello_tpu_torch/csrc/composite_src.cu",
                      "vello_tpu/ops/pallas_kernels.py:1084",
                      "gradient_image"),
    "composite_src_bf16": ("composite_src_bf16", "composite_src",
                           "composite_src_plain",
                           "vello_tpu_torch/csrc/composite_src.cu",
                           "vello_tpu/ops/pallas_kernels.py:1084",
                           "gradient_image_speed"),
    "composite_over": ("composite_over", "composite_over",
                       "composite_over_plain",
                       "vello_tpu_torch/csrc/composite_over.cu",
                       "vello_tpu/ops/pallas_kernels.py:1183", "layered"),
    "composite_over_bf16": ("composite_over_bf16", "composite_over",
                            "composite_over_plain",
                            "vello_tpu_torch/csrc/composite_over.cu",
                            "vello_tpu/ops/pallas_kernels.py:1183",
                            "layered_speed"),
    "cumsum": ("cumsum", "cumsum0", "cumsum0_plain",
               "vello_tpu_torch/csrc/cumsum.cu",
               "vello_tpu/ops/pallas_kernels.py:496", "layered_unrolled"),
    "cumsum_layered_tier": ("cumsum", "cumsum0", "cumsum0_plain",
                            "vello_tpu_torch/csrc/cumsum.cu",
                            "vello_tpu/ops/pallas_kernels.py:496",
                            "layered_unrolled"),
    # no TPU kernel: the JAX package's XLA fuses the segment chain
    "segment_prep": ("segment_prep", "segment_prep", "segment_prep_plain",
                     "vello_tpu_torch/csrc/segment_prep.cu",
                     "none (vello_tpu/ops/flatten.py:222)", "msaa16"),
    "segment_prep_stroked": ("segment_prep", "segment_prep",
                             "segment_prep_plain",
                             "vello_tpu_torch/csrc/segment_prep.cu",
                             "none (vello_tpu/ops/flatten.py:222)",
                             "stroked"),
}
# the occlusion walk's starts (no TPU kernel: the JAX package's XLA runs a
# cummax over every fragment), on three frames' inputs: entry
# occlusion_los_<path>
for _path in ("msaa16", "stroked", "gradient_image"):
    KERNELS[f"occlusion_los_{_path}"] = (
        "occlusion_los", "occlusion_los", "occlusion_los_plain",
        "vello_tpu_torch/csrc/composite_solid.cu",
        "none (vello_tpu/pipeline/render.py:580)", _path)
# the centers paths' four kernels, each held on its path's inputs: entry
# <kernel>_<path> (K5 with its centers threshold)
CENTERS_PATHS = ("centers", "msaa16_supersampled", "msaa8_supersampled")
for _path in CENTERS_PATHS:
    KERNELS.update({
        f"flatten_{_path}": ("flatten", "flatten_lines",
                             "flatten_lines_plain",
                             "vello_tpu_torch/csrc/flatten.cu",
                             "vello_tpu/ops/pallas_kernels.py:711", _path),
        f"expand_touches_{_path}": ("expand_touches", "expand_touches",
                                    "expand_touches_plain",
                                    "vello_tpu_torch/csrc/expand_touches.cu",
                                    "vello_tpu/ops/pallas_kernels.py:911",
                                    _path),
        f"coverage_area_{_path}": ("coverage_area", "coverage_area",
                                   "coverage_area_plain",
                                   "vello_tpu_torch/csrc/coverage_area.cu",
                                   "vello_tpu/ops/pallas_kernels.py:84",
                                   _path),
        f"composite_solid_{_path}": ("composite_solid", "composite_solid",
                                     "composite_solid_plain",
                                     "vello_tpu_torch/csrc/composite_solid.cu",
                                     "vello_tpu/ops/pallas_kernels.py:1303",
                                     _path)})

# launch counter -> (the name its CUDA kernels carry in a profiler trace,
# the stage range of the frame that launches it)
KERNEL_STAGES = {
    "flatten": (("flatten_kernel",), "s02_flatten"),
    "expand_touches": (("expand_touches_kernel",), "s03_touch_expand"),
    "msaa_coverage": (("msaa_coverage_kernel",), "s08_coverage_assembly"),
    "coverage_area": (("coverage_area_kernel",), "s06_coverage"),
    "coverage_area_raw": (("coverage_area_raw_kernel",), "s06_coverage"),
    "composite_solid": (("composite_solid_kernel",), "s10_composite"),
    "composite_src": (("composite_src_kernel",), "s10_composite"),
    "composite_src_bf16": (("composite_src_bf16_kernel",), "s10_composite"),
    "composite_over": (("composite_over_kernel",), "s20_op_draws"),
    "composite_over_bf16": (("composite_over_bf16_kernel",),
                            "s20_op_draws"),
    "cumsum": (("cumsum_totals_kernel", "cumsum_carries_kernel",
                "cumsum_rows_kernel"), "s21_op_push"),
    "segment_prep": (("segment_prep_kernel", "segment_offsets_kernel"),
                     "s02_flatten"),
    "occlusion_los": (("occlusion_los_kernel",), "s09b_occlusion"),
}

# frame path -> (scene, antialiasing, the launch counters of its kernels);
# a path named *_speed renders in render_mode "speed", one named
# *_supersampled with VELLO_TPU_SUPERSAMPLE_MSAA=1 (``path_env``): its
# frame is the "centers" frame of the scene scaled by k (4 for msaa16, 3
# for msaa8) at k*SIZE square, then the k x k box resolve
PATHS = {
    "msaa16": ("filled_mmark", "msaa16",
               ("segment_prep", "flatten", "expand_touches", "msaa_coverage",
                "occlusion_los", "composite_solid")),
    "area": ("filled_mmark", "area",
             ("segment_prep", "flatten", "expand_touches", "coverage_area",
              "occlusion_los", "composite_solid")),
    "gradient_image": ("mixed_paint_mmark", "msaa16",
                       ("segment_prep", "flatten", "expand_touches",
                        "msaa_coverage", "occlusion_los", "composite_src")),
    "stroked": ("mmark", "msaa16",
                ("segment_prep", "flatten", "expand_touches", "msaa_coverage",
                 "occlusion_los", "composite_solid")),
    "layered": ("layered_mmark", "msaa16",
                ("segment_prep", "flatten", "expand_touches", "msaa_coverage",
                 "composite_over")),
    "layered_unrolled": ("blend_grid", "msaa16",
                         ("segment_prep", "flatten", "expand_touches",
                          "msaa_coverage", "composite_over", "cumsum")),
    "msaa16_speed": ("filled_mmark", "msaa16",
                     ("segment_prep", "flatten", "expand_touches",
                      "msaa_coverage", "occlusion_los", "composite_solid")),
    "gradient_image_speed": ("mixed_paint_mmark", "msaa16",
                             ("segment_prep", "flatten", "expand_touches",
                              "msaa_coverage", "occlusion_los",
                              "composite_src_bf16")),
    "layered_speed": ("layered_mmark", "msaa16",
                      ("segment_prep", "flatten", "expand_touches",
                       "msaa_coverage", "composite_over_bf16")),
    "centers": ("filled_mmark", "centers",
                ("segment_prep", "flatten", "expand_touches", "coverage_area",
                 "occlusion_los", "composite_solid")),
    "msaa16_supersampled": ("filled_mmark", "msaa16",
                            ("segment_prep", "flatten", "expand_touches",
                             "coverage_area", "occlusion_los",
                             "composite_solid")),
    "msaa8_supersampled": ("filled_mmark", "msaa8",
                           ("segment_prep", "flatten", "expand_touches",
                            "coverage_area", "occlusion_los",
                            "composite_solid")),
}
UNROLLED = "VELLO_TPU_UNROLLED_LAYERS"
SUPERSAMPLE = "VELLO_TPU_SUPERSAMPLE_MSAA"
# the supersampled msaa16 frame against the sample-mask msaa16 frame of the
# same scene, f32 mean abs (tests/test_torch_supersample.py: 0.0041 and
# 0.0046 at 128^2)
SAMPLE_MASK_MEAN = 1e-2
# phase 5's supersampled frames, (complexity, size): filled_mmark(1, 128.),
# also held to the port's oracle, which composites every path over the
# whole (k*size)^2 frame: on the CPU filled_mmark(1, 128.) takes it 8 and
# 14 s (msaa8, msaa16), filled_mmark(1, 256.) 39 and 83 s
SUPERSAMPLED_CHECK = (1, 128)

# phase 6: the ported reference scenes at the sizes of
# tests/test_reference_goldens.py (SIZES), with its bars: the frame within
# ORACLE_MEAN_TOL mean abs of the port's oracle, and within the golden
# tests/snapshots/ref_<name>.png by the rules of tests/snapshot.py (RGBA8,
# mean and max of |diff| / 255)
CORPUS_SIZES = {
    "funky_paths": (600, 600),
    "fill_types": (350, 175),
    "gradient_extend": (200, 200),
    "deep_blend": (200, 200),
    "many_clips": (200, 200),
    "clip_test": (512, 768),
    "blurred_rounded_rect": (200, 200),
    "longpathdash_butt": (220, 40),
    "longpathdash_round": (220, 40),
    "stroke_styles_non_uniform": (310, 180),
    "stroke_styles_skew": (512, 256),
    "luminance_mask": (55, 55),
    "two_point_radial": (260, 240),
    "conflation_artifacts": (250, 350),
    "labyrinth": (250, 250),
    "robust_paths": (600, 150),
    "blend_grid": (225, 225),
    "cardioid_and_friends": (256, 192),
    "image_sampling": (220, 220),
    "image_sampling_bicubic": (280, 180),
    "image_extend_modes_bilinear": (300, 300),
    "image_extend_modes_nearest": (300, 300),
    "brush_transform": (260, 180),
    "many_draw_objects": (400, 300),
}
# the scenes that draw text in Roboto, which the repository does not hold
ROBOTO_SCENES = ("clip_test", "fill_types", "gradient_extend")
# 90k paths: held to the golden only (the scanline oracle takes minutes)
GOLDEN_ONLY = ("many_draw_objects",)
ORACLE_MEAN_TOL = 2.5e-3
GOLDEN_MEAN_TOL = 0.002
GOLDEN_MAX_TOL = 4.01 / 255.0
CORPUS_WARM_FRAMES = 5
REPO = os.path.dirname(os.path.abspath(__file__))
SNAPSHOTS = os.path.join(REPO, "tests", "snapshots")

# f32 operations per unit of work (compares, selects, a divide and integer
# steps count as one each): K4, K6, K7 as counted from their sources; K1,
# K2, K3 and K5 as the function needs them on these inputs, whatever
# computes it (a term is counted once for the inputs it depends on; the
# search for a slot's owner is the kernels' means, not the function's work)
OPS_FILL_SLOT = 181          # K1 per live fill slot: t0, t1 (4), 2 cubic
                             # points (48), y trim (25), alive (8), x clamp
                             # and left edge (47), orientation (5), DDA
                             # count (29), on_right and live (9), outputs (4)
OPS_STROKE_MINI = 142        # K1 per (stroked segment, mini): 3 t (6), 3
                             # cubic points (72), 2 chord normals (21), the
                             # join normal, side and bevel corners (33), the
                             # 7 corner points (8), the collapse (2)
OPS_STROKE_SLOT = 144        # K1 per live stroke slot: mini and edge (7),
                             # the edge's endpoints (10), then a fill slot's
                             # work from the y trim on (127)
OPS_TOUCH_LINE = 69          # K2 per line with a live touch: the DDA setup
                             # (spans, count, a with its correction, b, the
                             # first tile, 1/dxl, 1/dyl)
OPS_PER_TOUCH = 142          # K2 per live touch: z(i-1), z(i), z(i+1), the
                             # tile, ftile, backdrop, the tile clip, the
                             # path_tiling rules, outputs
OPS_MSAA_TOUCH = 10          # K3 per touch: dx, dy, ymin, ymax, the dy == 0
                             # select, 1 / dy, a = inv_dy * dx, two signs
OPS_MSAA_SAMPLE_ROW = 5      # K3 per (touch, tile row, sample): the
                             # crossing test (2 compares, and), the y_edge
                             # compare and add
OPS_MSAA_CROSSING = 7        # K3 per (touch, sample row) it crosses: xt
                             # (3), the step's pixel (subtract, floor,
                             # convert), the step's add
OPS_MSAA_RESOLVE = 5        # K3 per (fragment with touches, pixel,
                             # sample): the step prefix, + backdrop, the
                             # fill rule (2), the sample sum
OPS_AREA_TOUCH = 6           # K5 per touch: dx, dy, the dy == 0 select,
                             # 1 / dy, the sign (2)
OPS_AREA_ROW = 16            # K5 per (touch, tile row): y, y0 (2), y1 (3),
                             # dyc, t0 (2), t1 (2), the y_edge term (5)
OPS_AREA_CROSSED = 21        # K5 per (touch, pixel) of a row the touch
                             # crosses (dyc != 0): startx, x0 and x1 (an
                             # fma each, 2), xmin (3), xmax, b, c, d, the
                             # numerator (6), the denominator, the divide,
                             # * dyc
OPS_AREA_PIXEL = 2           # K5 per (touch, pixel): + edge term, the sum
OPS_AREA_RESOLVE = 4         # K5 per (valid fragment, pixel): + backdrop,
                             # the fill rule (2), the centers threshold
OPS_PER_COMPOSITE = 18       # K4: per fragment and pixel, 4 channels
OPS_PER_SRC_COMPOSITE = 9    # K6: per fragment and pixel, 4 channels
OPS_PER_OVER_COMPOSITE = 9   # K7: per fragment and pixel: 1 - a, then a
                             # multiply and an add per channel


def layer_features(size: float):
    """Every pop branch of the layered compositor in one scene: a collapsed
    clip chain, a pushed clip, a luminance mask and an alpha mask (each in
    a group), a multiply layer, a blur-filtered layer and an unbalanced
    push, over a gradient backdrop."""
    import vello_tpu_torch as vt
    from vello_tpu_torch.kurbo import circle_path, rect_path, star_path
    from vello_tpu_torch.peniko import stops

    k = size / 128.0
    s, a, nz, p = vt.Scene(), vt.Affine.identity(), vt.Fill.NON_ZERO, \
        vt.palette
    s.fill(nz, a, vt.Gradient.linear((0, 0), (size, size),
                                     stops(p.NAVY, p.ORANGE)), None,
           rect_path(0, 0, size, size))
    s.push_clip_layer(a, circle_path(30 * k, 30 * k, 26 * k))
    s.push_clip_layer(a, rect_path(8 * k, 10 * k, 50 * k, 44 * k))
    s.fill(nz, a, vt.Color(0.2, 0.45, 0.8, 0.9), None,
           rect_path(0, 0, size, size))
    s.pop_layer()
    s.pop_layer()
    s.push_clip_layer(a, star_path(94 * k, 30 * k, 5, 10 * k, 28 * k))
    s.fill(nz, a, vt.Color(0.7, 0.15, 0.3, 0.8), None,
           circle_path(86 * k, 30 * k, 16 * k))
    s.fill(nz, a, vt.Color(0.1, 0.6, 0.35, 0.7), None,
           circle_path(102 * k, 38 * k, 18 * k))
    s.pop_layer()
    s.push_layer(vt.Mix.NORMAL, 1.0, a, None)
    s.fill(nz, a, vt.Color(0.91, 0.83, 0.18, 1.0), None,
           rect_path(4 * k, 60 * k, 60 * k, 124 * k))
    s.push_luminance_mask_layer(0.9, a, rect_path(0, 56 * k, 64 * k, size))
    s.fill(nz, a, vt.Gradient.radial((32 * k, 92 * k), 30 * k,
                                     stops(p.WHITE, p.BLACK)), None,
           circle_path(32 * k, 92 * k, 30 * k))
    s.pop_layer()
    s.pop_layer()
    s.push_layer(vt.Mix.NORMAL, 1.0, a, None)
    s.fill(nz, a, vt.Color(0.13, 0.73, 0.58, 1.0), None,
           rect_path(68 * k, 60 * k, 124 * k, 124 * k))
    s.push_alpha_mask_layer(0.8, a, circle_path(96 * k, 92 * k, 28 * k))
    s.fill(nz, a, vt.Color(0.5, 0.5, 0.5, 0.6), None,
           star_path(96 * k, 92 * k, 6, 10 * k, 32 * k))
    s.pop_layer()
    s.pop_layer()
    s.push_layer(vt.Mix.MULTIPLY, 0.85, a, None)
    s.fill(nz, a, p.LIME, None, circle_path(64 * k, 64 * k, 20 * k))
    s.pop_layer()
    s.push_blur_layer(3.0 * k)
    s.fill(nz, a, p.CYAN, None, star_path(64 * k, 100 * k, 6, 8 * k, 20 * k))
    s.pop_layer()
    s.push_layer(vt.Mix.SCREEN, 0.9, a, None)
    s.fill(nz, a, p.RED, None, circle_path(110 * k, 110 * k, 14 * k))
    return s


def make_scene(test_scenes, name: str, complexity: int, size: float):
    """A scene of vello_tpu_torch.scenes.test_scenes at ``size``; blend_grid
    has no complexity."""
    if name == "blend_grid":
        return test_scenes.blend_grid(size)
    return getattr(test_scenes, name)(complexity, size)


def render_params(RenderParams, path: str, size: int):
    """The path's RenderParams at size x size: its antialiasing, and
    render_mode "speed" for a *_speed path."""
    return RenderParams(size, size, base_color=BASE,
                        antialiasing=PATHS[path][1],
                        render_mode=("speed" if path.endswith("_speed")
                                     else "quality"))


@contextlib.contextmanager
def path_env(path: str):
    """VELLO_TPU_UNROLLED_LAYERS=1 for the layered_unrolled path and
    VELLO_TPU_SUPERSAMPLE_MSAA=1 for a *_supersampled path, each unset for
    every other; restored after."""
    old = {k: os.environ.pop(k, None) for k in (UNROLLED, SUPERSAMPLE)}
    if path == "layered_unrolled":
        os.environ[UNROLLED] = "1"
    if path.endswith("_supersampled"):
        os.environ[SUPERSAMPLE] = "1"
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def k7_counter(path: str) -> str:
    """The launch counter of a layered path's K7: composite_over, or
    composite_over_bf16 on the bf16 src of a speed path."""
    return [c for c in PATHS[path][2] if c.startswith("composite_over")][0]


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def is_kernel_of(counter, kernel_name) -> bool:
    return any(sym in kernel_name for sym in KERNEL_STAGES[counter][0])


def profiled_ms(counter, fn, reps: int):
    """Device time per call of fn's kernels of ``counter`` in a profiler
    trace of reps calls, after a warm-up: kernel time alone, without the
    launch gaps that CUDA events around the calls include. The trace is
    read as ``Renderer.profile`` reads a frame's. A call launches each of
    its kernels once; a trace can lose kernel events, so each kernel's
    time is its mean over the events kept. Returns (ms, events kept,
    events launched), ms None when the trace kept none."""
    from vello_tpu_torch.utils.profile import profile_stages
    _, split, counts, _ = profile_stages(fn, iters=reps, detail=True)
    ms, kept = defaultdict(float), defaultdict(int)
    for (st, k), t in split.items():
        if is_kernel_of(counter, k):
            ms[k] += t * reps
            kept[k] += counts[(st, k)]
    n = len(KERNEL_STAGES[counter][0])
    return (sum(ms[k] / kept[k] for k in ms) if ms else None,
            sum(kept.values()), n * reps)


def check_stages(path, stages, split, used, launches) -> dict:
    """Hold a path's Renderer.profile to the trace: stage ranges cover
    all but 5% of the device time, and each kernel of the path runs under
    its stage only. Returns {counter: in-frame kernel ms per launch}."""
    if not stages:
        fail(f"[{path}] Renderer.profile found no device time")
    total = stages["_total"]
    if stages["_other"] > 0.05 * total:
        top = sorted((ms, k) for (st, k), ms in split.items()
                     if st == "_other")[-5:]
        fail(f"[{path}] {stages['_other']:.4f} of {total:.4f} device ms per "
             f"frame under no stage (more than 5%), largest: {top}")
    per_launch = {}
    for counter in used:
        want = KERNEL_STAGES[counter][1]
        mine = {st: 0.0 for st, _ in split}
        for (st, k), ms in split.items():
            if is_kernel_of(counter, k):
                mine[st] += ms
        if mine.get(want, 0.0) <= 0.0 or any(
                ms > 0.0 for st, ms in mine.items() if st != want):
            fail(f"[{path}] {counter}'s kernels by stage {mine}: expected "
                 f"all under {want}")
        per_launch[counter] = mine[want] / launches[counter]
    return per_launch


def frame_share(path, counter, bound_ms, in_frame, path_launches):
    """A kernel launched many times a frame (K7 per draws op, K8 per
    clipped push) in the frame against the bound of the same work, the sum
    of its launches' bounds (one launch alone, timed again and again on
    the same buffers, runs from L2)."""
    n = path_launches[path][counter]
    ms = in_frame[path][counter] * n
    print(f"{counter}: in the {path} frame, {n} launches: profiled kernel "
          f"ms per frame {ms:.4f}, the sum of their bounds {bound_ms:.4f} "
          f"ms, share {bound_ms / ms:.3f}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def capture_calls(module, frame, names):
    """Run one frame with the functions ``names`` of ``module`` wrapped to
    record their arguments; returns {name: (args, kwargs)}."""
    captured = {}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name):
        def wrapped(*args, **kwargs):
            captured[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return wrapped

    try:
        for name in names:
            setattr(module, name, recorder(name))
        frame()
        torch.cuda.synchronize()
    finally:
        for name in names:
            setattr(module, name, originals[name])
    missing = set(names) - set(captured)
    if missing:
        fail(f"the frame did not call {sorted(missing)}")
    return captured


def capture_largest_over(kernels, frame, name="composite_over"):
    """Run one frame with K7's wrapper wrapped; returns the (args, kwargs)
    of its draws op that walks the most rows, with a clone of the buffer
    as it was before that op (the kernel updates it in place), and the sum
    of the bounds of all the frame's draws ops, ms (``name`` the kernels
    line's entry: composite_over, or composite_over_bf16 on bf16 src)."""
    best = {"walked": -1, "bound_ms": 0.0}
    original = kernels.composite_over

    def wrapped(src, dst, los, his):
        walked = int((his - los).clamp_min(0).sum())
        best["bound_ms"] += bound(name, (src, dst, los, his), None)[0]
        if walked > best["walked"]:
            best.update(walked=walked, args=(src, dst.clone(), los, his))
        return original(src, dst, los, his)

    kernels.composite_over = wrapped
    try:
        frame()
        torch.cuda.synchronize()
    finally:
        kernels.composite_over = original
    if "args" not in best:
        fail("the layered frame did not call composite_over")
    return (best["args"], {}), best["bound_ms"]


def capture_largest_cumsum(kernels, frame):
    """Run one frame with K8's wrapper wrapped; returns the (args, kwargs)
    of its call on the clipped push with the most non-zero coverage rows,
    and the sum of the bounds of all the frame's calls, ms."""
    best = {"rows": -1, "bound_ms": 0.0}
    original = kernels.cumsum0

    def wrapped(x):
        rows = int((x != 0).any(dim=1).sum())
        if rows > best["rows"]:
            best.update(rows=rows, args=(x,))
        out = original(x)
        best["bound_ms"] += bound("cumsum", (x,), out)[0]
        return out

    kernels.cumsum0 = wrapped
    try:
        frame()
        torch.cuda.synchronize()
    finally:
        kernels.cumsum0 = original
    if "args" not in best:
        fail("the unrolled layered frame did not call cumsum0")
    print(f"cumsum: the largest clipped push has {best['rows']} non-zero "
          f"rows of {best['args'][0].shape[0]}")
    return (best["args"], {}), best["bound_ms"]


def fresh_args(name, kargs):
    """The arguments of one kernel or plain run: K7 works in place, so each
    run gets its own copy of the buffer."""
    if name.startswith("composite_over"):
        return (kargs[0], kargs[1].clone()) + tuple(kargs[2:])
    return kargs


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def crossed_rows(trow, starts, valid) -> int:
    """The (touch, tile row) pairs of K5's valid fragments with dyc != 0,
    the rows where a pixel's area term is not 0 (the same f32 ops as the
    kernel)."""
    t = trow[:int(starts[-1])]
    own = torch.repeat_interleave(valid, (starts[1:] - starts[:-1]).long(),
                                  output_size=t.shape[0])
    t = t[own]
    rows = torch.arange(16, dtype=torch.float32, device=t.device)
    y = t[:, 1:2] - rows
    dyc = y.clamp(0.0, 1.0) - (y + (t[:, 3:4] - t[:, 1:2])).clamp(0.0, 1.0)
    return int((dyc != 0.0).sum())


def crossed_samples(trow, starts, fidx, valid, ns) -> int:
    """The (touch, sample row) pairs of K3's rows whose crossing test holds,
    ymin <= sy < ymax, over the 16 * ns sample rows sy = y + (s + 0.5) / ns
    of a tile (exact in f32 and ascending, so a touch's count is the
    difference of two searches)."""
    f = fidx.long()
    lo = starts[f].long()
    cnt = ((starts[f + 1] - starts[f]) * valid[f]).long()
    total = int(cnt.sum())
    # the touch index of each (row, touch) pair
    first = torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt,
                                    output_size=total)
    t = trow[first + torch.arange(total, device=trow.device)]
    ymin = torch.minimum(t[:, 1], t[:, 3]).contiguous()
    ymax = torch.maximum(t[:, 1], t[:, 3]).contiguous()
    sy = (torch.arange(16, dtype=torch.float32, device=trow.device)[:, None]
          + (torch.arange(ns, dtype=torch.float32, device=trow.device)
             + 0.5) / ns).reshape(-1)
    n = (torch.searchsorted(sy, ymax, side="left")
         - torch.searchsorted(sy, ymin, side="left"))
    return int(n.clamp_min(0).sum())


def msaa_row_paths(starts, fidx, backdrop, rule, valid, has_evenodd=True):
    """The rows of a K3 call by the path the kernel takes for them
    (csrc/msaa_coverage.cu): without touches (or invalid), and of a
    touched row by its backdrop and count n: even-odd (one bit plane), 4,
    6, 8 or 16 planes as 2 n + |backdrop| is below 16, 64, 256 or 2^16,
    else (or for a backdrop that is not an integer) the generic path."""
    f = fidx.long()
    cnt = ((starts[f + 1] - starts[f]) * valid[f]).long()
    bd = backdrop[f]
    integral = (bd == torch.round(bd)) & (bd.abs() < 65536.0)
    need = 2 * cnt + torch.where(integral, bd.abs(), 0.0).long()
    touched = cnt > 0
    planes = touched & integral & (need < 65536)
    evenodd = planes & (rule[f] == 1) & bool(has_evenodd)
    nonzero = planes & ~evenodd
    paths = {"untouched": int((~touched).sum()),
             "evenodd": int(evenodd.sum())}
    lo = 0
    for k in (4, 6, 8, 16):
        paths[f"planes{k}"] = int((nonzero & (need >= lo)
                                   & (need < 2 ** k)).sum())
        lo = 2 ** k
    paths["generic"] = int((touched & ~planes).sum())
    return paths


def capture_cell_msaa(kernels, Renderer, RenderParams):
    """The arguments of K3's call in one frame of the benchmark cell
    mmark.resident: its configuration's scene (benchmark/scenes/mmark_rs.py,
    geometry_seed 1) at its size and antialiasing, colors from one run
    seed (they change no K3 input)."""
    import types
    import vello_tpu_torch as vt
    from benchmark.scenes import mmark_rs
    with open(os.path.join(REPO, "benchmark", "configs", "mmark.json")) as f:
        config = json.load(f)
    api = types.SimpleNamespace(Scene=vt.Scene, kurbo=vt.kurbo,
                                peniko=vt.peniko)
    scene = mmark_rs.build(api, config, 3200000263, {})
    params = RenderParams(int(config["width"]), int(config["height"]),
                          tuple(config["base_color"]),
                          config["antialiasing"])
    r = Renderer(device="cuda")
    r.render(scene, params)
    return capture_calls(kernels, r.frame_thunk(), ["msaa_coverage"])[
        "msaa_coverage"]


def _live_slots(incl, n_slots):
    """Per owner of an inclusive count scan, its slots below the live
    total min(incl[-1], n_slots)."""
    incl = incl.long()
    offs = torch.cat([incl.new_zeros(1), incl[:-1]])
    total = min(int(incl[-1]), n_slots)
    return (incl.clamp_max(total) - offs).clamp_min(0)


def _scan_bytes(live) -> int:
    """The bytes of the count scan that finding the owners needs: its
    entries up to the last owner of a live slot, and the last entry (the
    total)."""
    owners = torch.nonzero(live).flatten()
    read = int(owners[-1]) + 1 if owners.numel() else 0
    return 4 * (read + int(read < live.shape[0]))


# K2 reads 13 of a line's 16 fields: not incl (row 6) and the two zero rows
TOUCH_LINE_ROWS = 13


def flatten_units(spack, incl, n_lines) -> dict:
    """K1's live work: fill slots, stroke slots, and the (stroked
    segment, mini) pairs they fall in (7 slots per mini, counted from the
    segment's first slot); and the bytes of its inputs it reads: the
    columns of the segments that own a live slot (16 of a fill-only pack;
    of a 21-column pack, 21 for a stroked segment and for a fill one its
    16 and the stroke flag) and ``_scan_bytes``."""
    live = _live_slots(incl, n_lines)
    stroked = (spack[:, 19] > 0.5 if spack.shape[1] == 21
               else torch.zeros_like(live, dtype=torch.bool))
    st = live[stroked]
    owners = live > 0
    n_st = int((owners & stroked).sum())
    fill_cols = 16 if spack.shape[1] == 16 else 17
    return {"fill_slots": int(live[~stroked].sum()),
            "stroke_slots": int(st.sum()),
            "stroke_minis": int(((st + 6) // 7).sum()),
            "read_bytes": 4 * (21 * n_st + fill_cols
                               * (int(owners.sum()) - n_st))
            + _scan_bytes(live)}


def touch_units(incl, n_touches) -> dict:
    """K2's live work: touches, and the lines they belong to; and the bytes
    of its inputs it reads: ``TOUCH_LINE_ROWS`` fields of each of those
    lines and ``_scan_bytes``."""
    live = _live_slots(incl, n_touches)
    lines = int((live > 0).sum())
    return {"touches": int(live.sum()), "lines": lines,
            "read_bytes": 4 * TOUCH_LINE_ROWS * lines + _scan_bytes(live)}


def occlusion_units(cov, opaque, starts, los) -> dict:
    """The occlusion walk's work: tiles and those with a full opaque cover,
    the rows in the tiles' ranges and those below ``los`` (hidden: no walk
    reads them), the rows a walk must look at (the opaque rows of [los,
    his): the cover and each opaque row above it), and the least bytes of
    its inputs that settle them: each cover's whole row, one DRAM sector
    (holding a value below the threshold) of every other such row, the
    opaque flags of [los, his) and the ranges."""
    from vello_tpu_torch.ops.kernels import FULL_COVER
    lo, hi = starts[:-1].long(), starts[1:].long()
    keep = torch.zeros(cov.shape[0] + 1, dtype=torch.int64,
                       device=cov.device)
    keep.index_add_(0, los.long(), torch.ones_like(lo))
    keep.index_add_(0, hi, -torch.ones_like(hi))
    walked = torch.cumsum(keep, 0)[:-1] > 0          # in some [los, his)
    at = los.long().clamp_max(max(cov.shape[0] - 1, 0))
    cover = ((hi > lo) & opaque[at] & (cov[at].amin(dim=1) >= FULL_COVER)
             if cov.shape[0] else torch.zeros_like(lo, dtype=torch.bool))
    rows = int((walked & opaque).sum())
    covers = int(cover.sum())
    return {"tiles": int(lo.shape[0]), "tiles_with_cover": covers,
            "live_rows": int((hi - lo).sum()),
            "hidden_rows": int((los.long() - lo).sum()),
            "walked_rows": rows,
            "read_bytes": covers * cov.shape[1] * cov.element_size()
            + (rows - covers) * DRAM_SECTOR_BYTES + int(walked.sum())
            + _nbytes(starts)}


def print_walk_shares(name, work):
    """How often the occlusion walk engages on a frame's inputs."""
    print(f"{name}: tiles with a full opaque cover "
          f"{work['tiles_with_cover'] / max(work['tiles'], 1):.4f} of "
          f"{work['tiles']}; live rows left unread (below a cover) "
          f"{work['hidden_rows'] / max(work['live_rows'], 1):.4f} of "
          f"{work['live_rows']}")


def bound(name, args, out):
    """(least ms, "bytes" or "operations", the work counted) for one launch
    on these inputs: each input read once (of a composite's fragment rows,
    the ones its walks cover; of K1's and K2's, the rows and scan entries
    of the owners of live slots) and the output written once over the HBM
    rate, against the operations these inputs need over the f32 rate."""
    nbytes = _nbytes(*args, out)
    units = {}
    if name.startswith("flatten"):
        units = flatten_units(*args[:3])
        ops = (units["fill_slots"] * OPS_FILL_SLOT
               + units["stroke_minis"] * OPS_STROKE_MINI
               + units["stroke_slots"] * OPS_STROKE_SLOT)
        nbytes = units["read_bytes"] + _nbytes(out)
    elif name.startswith("expand_touches"):
        units = touch_units(*args[1:3])
        ops = (units["lines"] * OPS_TOUCH_LINE
               + units["touches"] * OPS_PER_TOUCH)
        nbytes = units["read_bytes"] + _nbytes(out)
    elif name.startswith("msaa_coverage"):
        trow, starts, fidx, backdrop, rule, valid, ns = args[:7]
        f = fidx.long()
        cnt = (starts[f + 1] - starts[f]) * valid[f]
        units = {"rows": int(f.shape[0]), "touches": int(cnt.sum()),
                 "crossings": crossed_samples(trow, starts, fidx, valid, ns),
                 "touched_rows": int((cnt > 0).sum()),
                 "row_paths": msaa_row_paths(starts, fidx, backdrop, rule,
                                             valid, *args[7:8])}
        ops = (units["touches"] * (OPS_MSAA_TOUCH
                                   + 16 * ns * OPS_MSAA_SAMPLE_ROW)
               + units["crossings"] * OPS_MSAA_CROSSING
               + units["touched_rows"] * 256 * ns * OPS_MSAA_RESOLVE)
    elif name.startswith("composite_over"):
        # in place: the walked src rows read (2 bytes a value in bf16),
        # each f32 tile with a non-empty walk read and written once, the
        # bounds read
        src, dst, los, his = args
        walked = int((his - los).clamp_min(0).sum())
        tiles = int((his > los).sum())
        nbytes = (_nbytes(los, his)
                  + walked * src[0].numel() * src.element_size()
                  + 2 * tiles * dst[0].numel() * dst.element_size())
        ops = walked * 256 * OPS_PER_OVER_COMPOSITE
    elif name.startswith("cumsum"):
        ops = args[0].numel()            # one add per element
    elif name.startswith("occlusion_los"):
        units = occlusion_units(*args, out)
        nbytes = units["read_bytes"] + _nbytes(out)
        ops = 0
    elif name.startswith("segment_prep"):
        # bytes: each segment's fields, each path's 6 rect fields (i32) and
        # n_segs read once, the pack and the count scan written once
        nbytes = (_nbytes(*args[:4], *args[5:7], *out)
                  + 24 * args[4]["tx0"].shape[0])
        ops = 0
    elif name.startswith("composite"):
        # a walk reads only its tiles' rows [los, his): the fragments
        # hidden under an opaque full cover, and the rows past the live
        # count, are never read
        rows, los, his = args[:-3], args[-2], args[-1]
        walked = int((his - los).clamp_min(0).sum())
        nbytes = (_nbytes(*args[-3:], out) + walked
                  * sum(r[0].numel() * r.element_size() for r in rows))
        ops = walked * 256 * (OPS_PER_COMPOSITE
                              if name.startswith("composite_solid")
                              else OPS_PER_SRC_COMPOSITE)
    elif name == "coverage_area_raw":
        # every fragment's sums, no backdrop, fill rule or threshold
        trow, starts = args
        valid = torch.ones(starts.shape[0] - 1, dtype=torch.bool,
                           device=trow.device)
        units = {"touches": int(starts[-1] - starts[0]),
                 "crossed_rows": crossed_rows(trow, starts, valid)}
        ops = (units["touches"] * (OPS_AREA_TOUCH + 16 * OPS_AREA_ROW
                                   + 256 * OPS_AREA_PIXEL)
               + units["crossed_rows"] * 16 * OPS_AREA_CROSSED)
    else:
        trow, starts, backdrop, rule, valid = args[:5]
        cnt = (starts[1:] - starts[:-1]) * valid
        units = {"touches": int(cnt.sum()),
                 "crossed_rows": crossed_rows(trow, starts, valid),
                 "valid_fragments": int(valid.sum())}
        ops = (units["touches"] * (OPS_AREA_TOUCH + 16 * OPS_AREA_ROW
                                   + 256 * OPS_AREA_PIXEL)
               + units["crossed_rows"] * 16 * OPS_AREA_CROSSED
               + units["valid_fragments"] * 256 * OPS_AREA_RESOLVE)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            dict(units, ops=ops, bytes=nbytes))


def compare(name, got, ref):
    """Hold a kernel's output to its plain version's; returns the max
    abs error. Bars: the geometry kernels (K1, K2), msaa coverage and the
    layered draws op, K5's raw entry and the segment preparation (its pack
    and count scan) exact (the same f32 ops in the same order, no
    contraction), the other composites atol 2e-5, area
    coverage atol 1e-6
    (the same op order: expected 0), and with its centers threshold (the
    coverage_area_<path> entries) bit-equal, since a residue would flip a
    sample; K8 exact on msaa clip coverage
    (multiples of 1/16: every prefix is exact) and within 2e-6 of the
    largest prefix on uniform values (both sum in f64 and round once, in
    different orders); the bf16 instantiations of K6 and K7 exact (each
    value widened exactly, then K6's and K7's f32 arithmetic)."""
    if isinstance(got, tuple):       # the segment preparation: spack, incl
        return max(compare(name, g, r) for g, r in zip(got, ref))
    got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"{name}: shape {got.shape} vs {ref.shape} or non-finite")
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    if name.startswith(("flatten", "expand_touches", "msaa_coverage",
                        "coverage_area_raw", "segment_prep",
                        "occlusion_los")):
        if not np.array_equal(got, ref):
            fail(f"{name}: differs from the plain version (max abs err "
                 f"{err}; expected bit-equal)")
    elif name == "coverage_area":
        if err > 1e-6:
            fail(f"coverage_area: max abs err {err} > 1e-6")
    elif name.startswith("coverage_area"):
        if not np.array_equal(got, ref):
            fail(f"{name}: differs from the plain version (max abs err "
                 f"{err}; expected bit-equal)")
    elif name == "cumsum":
        if err != 0.0:
            fail(f"cumsum: max abs err {err} on msaa clip coverage "
                 f"(expected 0: every prefix is exact)")
    elif name == "cumsum_layered_tier":
        bar = 2e-6 * float(np.abs(ref).max())
        if err > bar:
            fail(f"cumsum_layered_tier: max abs err {err} > {bar}")
    elif name.startswith("composite_over") or name.endswith("_bf16"):
        if err != 0.0:
            fail(f"{name}: max abs err {err} (expected 0: the same "
                 f"arithmetic in the same order)")
    elif not np.allclose(got, ref, rtol=0, atol=2e-5):
        fail(f"{name}: max abs err {err} > 2e-5")
    return err


def run_path(path, kernels, Renderer, RenderParams, resolve, scene,
             profile):
    """Drive one frame path at full size; returns (frame thunk, launch
    counts of its first frame, its u8 image, its profile, its kernels'
    in-frame ms per launch). A *_supersampled path's host tier and
    Renderer.profile are those of its centers frame, and its frame thunk
    runs the centers frame, the box resolve and the u8 conversion."""
    from vello_tpu_torch.models.renderer import (box_resolve, rgba8_device,
                                                 supersample_factor,
                                                 supersampled_scene)
    from vello_tpu_torch.pipeline import layered
    from vello_tpu_torch.utils.profile import profile_stages
    scene_name, aa, used = PATHS[path]
    params = render_params(RenderParams, path, SIZE)
    supersampled = path.endswith("_supersampled")
    # the frame the device renders: for a supersampled path, its centers
    # frame at k*SIZE square
    frame_scene, frame_params = ((supersampled_scene(scene, params))
                                 if supersampled else (scene, params))
    rs = resolve(frame_scene.encoding, frame_params)
    caps = rs.capacities(frame_params)
    expected = {name: int(name in used) for name in kernels.launches}
    if path.startswith("layered"):
        # K7 (f32 or bf16 src) launches once per draws op with a non-empty
        # path range, K8 once per clipped push of the unrolled formulation
        plan = layered.build_layer_plan(rs)[1]
        expected[k7_counter(path)] = layered.nonempty_draws(plan)
        if "cumsum" in used:
            expected["cumsum"] = layered.clipped_pushes(plan)
    del rs
    r = Renderer(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with path_env(path):
        kernels.reset_launches()
        t0 = time.perf_counter()
        img = r.render_u8(scene, params)
        first_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
    prof = r.last_profile
    # the stage ranges a frame opens: 11 flat, or the fragment stages, s19
    # and one per op of the plan
    prof["stage_ranges"] = (10 + int((plan["op_tab"][:, 0]
                                      != layered.OP_NOP).sum())
                            if path.startswith("layered") else 11)
    print(f"[{path}] first_frame_s {first_s:.4f} tier {prof['tier']} retries "
          f"{prof['retries']} n_live {prof['n_live']} launches {launches}"
          + (f" (centers frame {frame_params.width}x{frame_params.height},"
             f" host estimates {prof['est']})" if supersampled else ""))
    want = dict(zip(prof["tier"], caps.key()))
    if prof["retries"] != 0 or prof["tier"] != want:
        fail(f"[{path}] tier {prof['tier']} / retries {prof['retries']}: "
             f"expected the host's tier {want} and no retry")
    if img.shape != (SIZE, SIZE, 4) or img.dtype != np.uint8:
        fail(f"[{path}] image {img.shape} {img.dtype}")
    if img[..., 3].min() != 255 or len(np.unique(img[::8, ::8, 0])) < 16:
        fail(f"[{path}] image is not an opaque, varied frame")
    if prof["layered"] != path.startswith("layered"):
        fail(f"[{path}] layered {prof['layered']}")
    if launches != expected:
        fail(f"[{path}] launches {launches} in one frame, expected "
             f"{expected}")
    frame = r.frame_thunk()
    if supersampled:
        def frame(thunk=frame, k=supersample_factor(params)):
            img, overflow = thunk()
            return rgba8_device(box_resolve(img, SIZE, SIZE, k)), overflow
    _, overflow = frame()
    if int(overflow) != 0:
        fail(f"[{path}] warm frame overflow {int(overflow)}")
    times = []
    for _ in range(WARM_FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    warm = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{path}] warm_ms_per_frame median {warm:.3f} "
          f"min {min(times):.3f} max {max(times):.3f} over {WARM_FRAMES} "
          f"frames; peak_mem_gb {peak_gb:.2f}")
    # the per-stage device time of three traced warm frames (of the
    # centers frame, for a supersampled path); the frame it renders first
    # replaces the renderer's frame thunk, not ``frame``
    with path_env(path):
        stages = r.profile(frame_scene, frame_params)
    in_frame = check_stages(path, stages, r.last_profile["kernels"], used,
                            launches)
    print(f"[{path}] Renderer.profile device ms per frame: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    # the device time of the frame timed above (u8 out; Renderer.profile
    # traces the f32 frame, as the JAX package's does)
    device_ms = profile_stages(frame)["_total"]
    print(f"[{path}] device_ms_per_frame {device_ms:.4f} busy share "
          f"{device_ms / warm:.3f} (Renderer.profile's f32 frame "
          f"{stages['_total']:.4f}); in-frame kernel ms per launch "
          + ", ".join(f"{k} {v:.4f}" for k, v in in_frame.items()))
    prof["summary"] = {
        "first_frame_s": first_s, "tier": prof["tier"],
        "retries": prof["retries"], "n_live": prof["n_live"],
        "launches": {k: v for k, v in launches.items() if v},
        "warm_ms": [warm, min(times), max(times)], "peak_gb": peak_gb,
        "device_ms": device_ms, "busy": device_ms / warm,
        "profile_stages_ms": stages, "in_frame_ms_per_launch": in_frame}
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        os.makedirs(profile, exist_ok=True)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
            for _ in range(3):
                frame()
            torch.cuda.synchronize()
        table = p.key_averages().table(sort_by="cuda_time_total",
                                       row_limit=40)
        # two readings of one trace: the sum of the table's device rows
        # (the stage ranges' own device spans apart) and Renderer.profile's
        # total
        from torch.autograd import DeviceType
        from vello_tpu_torch.utils.profile import STAGE_RE, stage_kernel_ms
        rows = [e for e in p.key_averages()
                if e.device_type == DeviceType.CUDA]
        row_ms = sum(e.self_device_time_total for e in rows
                     if not STAGE_RE.match(e.key)) / 1e3 / 3
        span_ms = sum(e.self_device_time_total for e in rows
                      if STAGE_RE.match(e.key)) / 1e3 / 3
        raw = p.profiler.kineto_results.events()
        print(f"[{path}] one trace of 3 frames: device rows of the table "
              f"{row_ms:.4f} ms per frame (stage spans apart, {span_ms:.4f} "
              f"more), Renderer.profile's total "
              f"{stage_kernel_ms(raw, 3)[1]:.4f}")
        with open(os.path.join(profile, f"frame_profile_{path}.txt"),
                  "w") as f:
            f.write(f"3 warm frames, {scene_name}-{COMPLEXITY}k {SIZE}^2 "
                    f"{aa}\n{table}\n")
        print(table[:6000])
    return frame, launches, img, prof, in_frame


def corpus_names():
    """The reference scenes of phase 6: all but the Roboto ones."""
    from vello_tpu_torch.scenes.reference_scenes import REFERENCE_SCENES
    if set(REFERENCE_SCENES) != set(CORPUS_SIZES):
        fail(f"REFERENCE_SCENES {sorted(REFERENCE_SCENES)} is not the "
             f"corpus {sorted(CORPUS_SIZES)}")
    return sorted(set(CORPUS_SIZES) - set(ROBOTO_SCENES))


def golden_diff(name, img, png=None):
    """(mean, max) of |golden - frame| / 255 over the RGBA8 channels, the
    frame (premultiplied f32) quantized as tests/snapshot.py does; the
    golden tests/snapshots/ref_<name>.png, or ``png`` there."""
    from vello_tpu_torch.utils.png import read_png, to_rgba8
    golden = read_png(os.path.join(SNAPSHOTS, png or f"ref_{name}.png"))
    rgba = to_rgba8(img)
    if golden.shape != rgba.shape:
        fail(f"[corpus {name}] shape {rgba.shape} vs golden {golden.shape}")
    d = np.abs(golden.astype(np.float64) - rgba.astype(np.float64)) / 255.0
    return float(d.mean()), float(d.max())


def corpus_launches(rs, counters):
    """The launches one frame of a resolved scene takes in area AA: K1, K2
    and K5 once; then K7 once per non-empty draws op of a layered scene,
    or the occlusion walk and K4 (solid paints only) or K6 once."""
    from vello_tpu_torch.encoding.encoding import (DRAW_BEGIN_LAYER,
                                                   DRAW_END_LAYER)
    from vello_tpu_torch.pipeline import layered
    out = {name: 0 for name in counters}
    out.update(segment_prep=1, flatten=1, expand_touches=1,
               coverage_area=1)
    if any(int(k) in (DRAW_BEGIN_LAYER, DRAW_END_LAYER)
           for k in rs.draw_kind):
        out["composite_over"] = layered.nonempty_draws(
            layered.build_layer_plan(rs)[1])
    elif set(int(k) for k in rs.paint_kind) <= {0}:
        out.update(composite_solid=1, occlusion_los=1)
    else:
        out.update(composite_src=1, occlusion_los=1)
    return out


def check_probe(Renderer):
    """The device probe (utils/probe.py) against assets/probe.png within
    its 2 levels."""
    from vello_tpu_torch.utils import probe
    from vello_tpu_torch.utils.png import read_png, to_rgba8
    r = Renderer(device="cuda")
    ok = probe.run_probe(r)
    img = to_rgba8(r.render(probe.probe_scene(), probe.PROBE_PARAMS))
    diff = int(np.abs(read_png(probe.PROBE_PATH).astype(np.int16)
                      - img.astype(np.int16)).max())
    print(f"[probe] run_probe {ok}, max diff {diff} levels against "
          f"{os.path.relpath(probe.PROBE_PATH, REPO)}")
    if not ok:
        fail(f"the probe differs from its reference by {diff} levels")


def run_corpus(kernels, Renderer, RenderParams, resolve):
    """Phase 6: each reference scene of ``corpus_names`` through
    Renderer(device="cuda").render at its golden size and base color:
    the host's tier, no retry, its kernels' launches, the bars; returns
    {scene: (first-frame s, warm ms, device ms)}."""
    from vello_tpu_torch.oracle import OracleRenderer
    from vello_tpu_torch.scenes.reference_scenes import build_for_golden
    from vello_tpu_torch.utils.profile import profile_stages
    times = {}
    for name in corpus_names():
        w, h = CORPUS_SIZES[name]
        scene, base = build_for_golden(name, w, h)
        bc = ((base.r, base.g, base.b, base.a) if base is not None
              else (0.0, 0.0, 0.0, 1.0))
        params = RenderParams(w, h, base_color=bc)
        rs = resolve(scene.encoding, params)
        want_tier = rs.capacities(params).key()
        want = corpus_launches(rs, kernels.launches)
        del rs
        r = Renderer(device="cuda")
        kernels.reset_launches()
        t0 = time.perf_counter()
        img = r.render(scene, params)
        first_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        prof = r.last_profile
        frame = r.frame_thunk()
        _, overflow = frame()
        warm = []
        for _ in range(CORPUS_WARM_FRAMES):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        device_ms = profile_stages(frame).get("_total", 0.0)
        gmean, gmax = golden_diff(name, img)
        omean = (None if name in GOLDEN_ONLY else float(np.abs(
            img - OracleRenderer().render(scene, params)).mean()))
        times[name] = (first_s, statistics.median(warm), device_ms)
        print(f"[corpus {name}] {w}x{h} overflow {int(overflow)} retries "
              f"{prof['retries']} tier {prof['tier']} launches "
              f"{ {k: v for k, v in launches.items() if v} } first_frame_s "
              f"{first_s:.4f} warm_ms median {times[name][1]:.3f} (min "
              f"{min(warm):.3f} max {max(warm):.3f}, {CORPUS_WARM_FRAMES} "
              f"frames) device_ms {device_ms:.4f} oracle_mean_abs {omean} "
              f"golden_mean {gmean:.6f} golden_max {gmax * 255:.2f}/255")
        if int(overflow) or prof["retries"] or prof["tier"] != dict(
                zip(prof["tier"], want_tier)):
            fail(f"[corpus {name}] overflow {int(overflow)}, retries "
                 f"{prof['retries']}, tier {prof['tier']}: expected 0, 0 "
                 f"and the host's tier {want_tier}")
        if launches != want:
            fail(f"[corpus {name}] launches {launches}, expected {want}")
        if not np.isfinite(img).all() or img.shape != (h, w, 4):
            fail(f"[corpus {name}] image {img.shape}, not finite")
        if omean is not None and not omean < ORACLE_MEAN_TOL:
            fail(f"[corpus {name}] mean abs {omean} against the oracle, "
                 f"bar {ORACLE_MEAN_TOL}")
        if not (gmean < GOLDEN_MEAN_TOL and gmax < GOLDEN_MAX_TOL):
            fail(f"[corpus {name}] golden mean {gmean} (bar "
                 f"{GOLDEN_MEAN_TOL}), max {gmax} (bar {GOLDEN_MAX_TOL})")
    return times


# phase 7: the mesh (parallel/mesh.py) at full size, its ranks sharing the
# one card: case -> (scene, antialiasing, n_dp, n_sp, scene seeds, the
# launch counters of one rank's frame); layered_mmark goes through
# build_sharded_renderer with its scan_key, the others through
# MeshRenderer. The gloo worlds: MESH_WORLDS; then one dp=1 x sp=1 frame on
# NCCL.
MESH_CASES = {
    "mesh_msaa16": ("filled_mmark", "msaa16", 2, 2, (2, 3),
                    ("segment_prep", "flatten", "expand_touches",
                     "msaa_coverage", "occlusion_los", "composite_solid")),
    "mesh_area": ("filled_mmark", "area", 1, 2, (2,),
                  ("segment_prep", "flatten", "expand_touches",
                   "coverage_area_raw", "occlusion_los", "composite_solid")),
    "mesh_gradient_image": ("mixed_paint_mmark", "msaa16", 1, 2, (2,),
                            ("segment_prep", "flatten", "expand_touches",
                             "msaa_coverage", "occlusion_los",
                             "composite_src")),
    "mesh_layered": ("layered_mmark", "msaa16", 1, 2, (2,),
                     ("segment_prep", "flatten", "expand_touches",
                      "msaa_coverage", "composite_over")),
    "mesh_nccl": ("filled_mmark", "msaa16", 1, 1, (2,),
                  ("segment_prep", "flatten", "expand_touches",
                   "msaa_coverage", "occlusion_los", "composite_solid")),
}
# (backend, world size, its cases)
MESH_WORLDS = (("gloo", 4, ("mesh_msaa16",)),
               ("gloo", 2, ("mesh_area", "mesh_gradient_image",
                            "mesh_layered")),
               ("nccl", 1, ("mesh_nccl",)))
MESH_WARM_FRAMES = 5
MESH_TIMEOUT = 600.0


# phase 8: the port's bench at its defaults. Bench entry -> the phase 3
# path whose launch counts it must repeat.
BENCH_PATHS = {"headline": "msaa16", "area_quality": "area",
               "msaa16_speed": "msaa16_speed", "stroked_mmark": "stroked",
               "gradient_image_mmark": "gradient_image",
               "layered_mmark": "layered"}
BENCH_TIMEOUT = 600.0

# phase 9: text, from the repository's fonts only, in a subprocess
# (``--text``) that refuses the font packages before it imports the port.
# cell -> (scene, antialiasing, the launch counters of its frame); each at
# TEXT_SIZE square, and again at TEXT_CHECK_SIZE against the CPU frame
TEXT_PACKAGES = ("fontTools", "matplotlib", "PIL")
TEXT_SIZE = 1024
TEXT_CHECK_SIZE = 512
TEXT_CELLS = {
    "text_heavy": ("text_heavy", "area",
                   ("segment_prep", "flatten", "expand_touches",
                    "coverage_area", "occlusion_los", "composite_solid")),
    "text_heavy_msaa16": ("text_heavy", "msaa16",
                          ("segment_prep", "flatten", "expand_touches",
                           "msaa_coverage", "occlusion_los",
                           "composite_solid")),
    "text_scene": ("text_scene", "area",
                   ("segment_prep", "flatten", "expand_touches",
                    "coverage_area", "occlusion_los", "composite_src")),
    "glyph_runs": ("glyph_runs", "area",
                   ("segment_prep", "flatten", "expand_touches",
                    "coverage_area", "occlusion_los", "composite_solid")),
    "glyph_raster": ("glyph_raster", "area",
                     ("segment_prep", "flatten", "expand_touches",
                      "coverage_area", "occlusion_los", "composite_src")),
    # the emoji pickers (PICKERS): COLR v1 glyphs through the layered
    # compositor, K7 once per non-empty draws op; bitmap strikes as image
    # rects (K6)
    "color_glyphs": ("color_glyphs", "area",
                     ("segment_prep", "flatten", "expand_touches",
                      "coverage_area", "composite_over")),
    "bitmap_glyphs": ("bitmap_glyphs", "area",
                      ("segment_prep", "flatten", "expand_touches",
                       "coverage_area", "occlusion_los", "composite_src")),
}
# an emoji picker, as a chat client or an OS draws one: a DejaVu header
# line over PICKER_ROWS x PICKER_COLS color glyphs at PICKER_PX (scaled by
# size / TEXT_SIZE), cycling through the characters of the fonts the port
# ships in assets/fonts/test/; with two fonts, each draws half the rows.
# picker -> (font files, characters)
PICKER_COLS, PICKER_ROWS, PICKER_PX = 8, 6, 96.0
PICKER_HEADER = "Smileys & Emotion"
PICKER_FONT_DIR = os.path.join(REPO, "vello_tpu_torch", "assets", "fonts",
                               "test")
PICKERS = {
    "color_glyphs": (("ColrV1Paints.ttf",),
                     "\U0001F600\U0001F60D\U0001F308\u2B50\u2764"
                     "\U0001F389\U0001F31E\U0001F535\U0001F369"
                     "\U0001F3AF"),
    "bitmap_glyphs": (("CbdtStrikes.ttf", "SbixStrikes.ttf"),
                      "\U0001F600\U0001F534\u2764\u2B50\U0001F7E9"
                      "\U0001F315\U0001F3AF\U0001F536\U0001F30D"
                      "\U0001F4A7"),
}
# text_scene(128.) against its golden tests/snapshots/text_scene.png, on
# the base color of tests/test_torch_text.py
TEXT_GOLDEN_BASE = (0.05, 0.05, 0.05, 1.0)
TEXT_TIMEOUT = 600.0


def run_bench(path_launches, profiles):
    """Phase 8: ``python -m vello_tpu_torch.bench`` with bench.py's
    defaults (no BENCH_* or path variable of this process passed on), in
    its own session so that a timeout stops it and its nvcc processes.
    Holds its line to the checks of the docstring and returns it."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")
           and k not in (UNROLLED, SUPERSAMPLE)}
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "vello_tpu_torch.bench"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"the bench ran past {BENCH_TIMEOUT} s")
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(out[-3000:], err[-3000:], sep="\n")
        fail(f"the bench exited {proc.returncode} with "
             f"{len(lines)} lines of output")
    line = lines[-1]
    got = json.loads(line)
    extra = got["extra"]
    print(f"[bench] {seconds:.3f} s; {got['metric']}: {got['value']} fps")
    if got["metric"] == "error":
        fail(f"the bench's headline: {got.get('note')}")
    if (extra["backend"] != "cuda" or extra["device"]["platform"] != "gpu"
            or extra["build_s"] is None):
        fail(f"the bench ran on {extra['backend']} ({extra['device']}), "
             f"build_s {extra['build_s']}")
    entries = {"headline": extra}
    for name, e in {**extra["alt_fps"], **extra["scenes"]}.items():
        if isinstance(e, str) or "error" in e:
            fail(f"the bench's {name}: {e}")
        entries[name] = e
    if set(entries) != set(BENCH_PATHS):
        fail(f"the bench's entries {sorted(entries)}, expected "
             f"{sorted(BENCH_PATHS)}")
    batch = extra["batched"]
    for name, e in [*entries.items(), ("batched", batch)]:
        if e.get("retries", 0) != 0:
            fail(f"the bench's {name}: retries {e.get('retries')}")
        path = "msaa16" if name == "batched" else BENCH_PATHS[name]
        k = batch["batch"] if name == "batched" else 1
        want = {c: k * n for c, n in path_launches[path].items() if n}
        ref = profiles[path]["summary"]
        print(f"[bench] {name}: frame_ms {e['frame_ms']:.3f} launches "
              f"{e['launches']}; phase 3's "
              f"{path}: warm median {ref['warm_ms'][0]:.3f} ms, device ms "
              f"{ref['device_ms']:.4f}")
        if e["launches"] != want:
            fail(f"the bench's {name}: launches {e['launches']}, phase 3's "
                 f"{path} path {want}")
    return line


def mesh_scene(test_scenes, name, seed):
    return getattr(test_scenes, name)(COMPLEXITY, float(SIZE), seed=seed)


def mesh_rank(rank, world, cases, backend):
    """One rank of a phase 7 world: each case's first batch (launch counts
    reset just before it, read just after, held to the case's counters),
    its warm frames, device ms and peak memory; rank 0 also returns the
    stitched frames, and on the area case holds K5's raw entry to its
    plain version on its own inputs."""
    from vello_tpu_torch import RenderParams, resolve
    from vello_tpu_torch.models.renderer import (pack_buffers,
                                                 pipeline_static, to_torch)
    from vello_tpu_torch.ops import fine, kernels
    from vello_tpu_torch.parallel.mesh import (MeshRenderer,
                                               build_sharded_renderer,
                                               make_mesh)
    from vello_tpu_torch.pipeline import layered
    from vello_tpu_torch.scenes import test_scenes
    from vello_tpu_torch.utils.profile import profile_stages
    out = {}
    for case in cases:
        scene_name, aa, n_dp, n_sp, seeds, used = MESH_CASES[case]
        mesh = make_mesh(n_dp, n_sp, backend, "cuda:0")
        params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
        resolved = [resolve(mesh_scene(test_scenes, scene_name,
                                       seed).encoding, params)
                    for seed in seeds]
        expected = {k: int(k in used) for k in kernels.launches}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if scene_name == "layered_mmark":
            rs = resolved[0]
            plan_dyn, scan_key = layered.build_layer_plan(rs)[1:3]
            expected["composite_over"] = layered.nonempty_draws(plan_dyn)
            caps = rs.capacities(params)
            fn = build_sharded_renderer(
                pipeline_static([rs], caps, params), mesh, scan_key=scan_key)
            # on the card once, as MeshRenderer keeps its batch: the timed
            # frames upload nothing
            bufs = [to_torch(pack_buffers(rs, caps, params), mesh.device)]
            if "path_clipalpha" in plan_dyn:
                plan_dyn = dict(plan_dyn, path_clipalpha=torch.from_numpy(
                    plan_dyn["path_clipalpha"]).to(mesh.device))
            kernels.reset_launches()
            imgs, words = fn(bufs, plan_dyn)
            launches = dict(kernels.launches)
            prof = {"retries": 0}       # the host's tier; no retry loop

            def frame(f=fn, b=bufs, p=plan_dyn):
                return f(b, p)
        else:
            mr = MeshRenderer(mesh)
            kernels.reset_launches()
            imgs = mr.render_batch(resolved, params)
            launches = dict(kernels.launches)
            prof = mr.last_profile
            # the host's shared tier: each capacity the batch's largest
            want = tuple(map(max, zip(*[r.capacities(params).key()
                                        for r in resolved])))
            if tuple(prof["tier"].values()) != want:
                raise RuntimeError(f"[{case}] tier {prof['tier']}, expected "
                                   f"the host's shared tier {want}")
            frame = mr.frame_thunk()
            words = frame()[1]
        if prof["retries"] or words.any():
            raise RuntimeError(f"[{case}] retries {prof['retries']}, "
                               f"overflow {words}")
        if launches != expected:
            raise RuntimeError(f"[{case}] rank {rank} launches {launches}, "
                               f"expected {expected}")
        times = []
        for _ in range(MESH_WARM_FRAMES):
            t0 = time.perf_counter()
            frame()
            times.append((time.perf_counter() - t0) * 1e3)
        stages, split, _, _ = profile_stages(frame, detail=True)
        raw_ms = sum(ms for (_, k), ms in split.items()
                     if is_kernel_of("coverage_area_raw", k))
        res = {"launches": {k: v for k, v in launches.items() if v},
               "warm_ms": statistics.median(times), "warm_min": min(times),
               "warm_max": max(times),
               "device_ms": stages.get("_total"), "stages": stages,
               "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "raw_in_frame_ms": raw_ms or None}
        if aa == "area":
            # every rank runs the captured frame (its all-reduces)
            calls = capture_calls(kernels, frame, ["coverage_area_raw"])
        if rank == 0:
            res["imgs"] = imgs
            if aa == "area":
                args, kw = calls["coverage_area_raw"]
                got = kernels.coverage_area_raw(*args)
                ref = fine.coverage_area_raw_plain(*args)
                torch.cuda.synchronize()
                err = compare("coverage_area_raw", got, ref)
                del got, ref
                ms = cuda_ms(lambda: kernels.coverage_area_raw(*args), 20)
                prof_ms, kept, launched = profiled_ms(
                    "coverage_area_raw",
                    lambda: kernels.coverage_area_raw(*args), 5)
                plain_ms = cuda_ms(
                    lambda: fine.coverage_area_raw_plain(*args), 3)
                bound_ms, bound_by, work = bound(
                    "coverage_area_raw", args,
                    kernels.coverage_area_raw(*args))
                res["raw"] = {"max_abs_err": err, "ms": ms,
                              "profiled_ms": prof_ms, "kept": kept,
                              "launched": launched, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "work": work, "shape": tuple(args[0].shape),
                              "launches": launches["coverage_area_raw"]}
        out[case] = res
    return out


def mesh_references(Renderer, RenderParams, test_scenes):
    """The single-device frames of phase 7's scenes, f32, from
    Renderer(device="cuda"): {(case, seed): image}."""
    refs = {}
    for case, (scene_name, aa, _, _, seeds, _) in MESH_CASES.items():
        params = RenderParams(SIZE, SIZE, base_color=BASE, antialiasing=aa)
        for seed in seeds:
            refs[(case, seed)] = Renderer(device="cuda").render(
                mesh_scene(test_scenes, scene_name, seed), params)
    torch.cuda.empty_cache()
    return refs


def run_mesh(Renderer, RenderParams, test_scenes):
    """Phase 7: each world's ranks spawned on the one card (the kernels
    were built in phase 2; the ranks load the library), each stitched
    frame held to the single-device frame: msaa byte-identical
    expected, bar 1 u8 level (the u8 rule of the frame's kind); area 1
    level. Returns the kernels-line entry of K5's raw entry."""
    from vello_tpu_torch.parallel.launch import run_ranks
    from vello_tpu_torch.pipeline.layered import to_rgba8 as layered_rgba8
    from vello_tpu_torch.utils.png import to_rgba8
    t0 = time.perf_counter()
    refs = mesh_references(Renderer, RenderParams, test_scenes)
    print(f"[mesh] single-device references in "
          f"{time.perf_counter() - t0:.3f} s")
    raw_entry = None
    for backend, world, cases in MESH_WORLDS:
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_rank, world, (cases, backend),
                          backend=backend, timeout=MESH_TIMEOUT)
        print(f"[mesh] {backend} world of {world} ranks on one card: "
              f"{time.perf_counter() - t0:.3f} s")
        for case in cases:
            scene_name, aa, n_dp, n_sp, seeds, _ = MESH_CASES[case]
            for r, res in enumerate(ranks):
                m = res[case]
                print(f"[{case}] rank {r} of dp={n_dp} x sp={n_sp} "
                      f"({backend}, {world} ranks on one card: not a scaling "
                      f"figure) launches {m['launches']} warm_ms median "
                      f"{m['warm_ms']:.3f} (min {m['warm_min']:.3f} max "
                      f"{m['warm_max']:.3f}, {MESH_WARM_FRAMES} frames) "
                      f"device_ms {m['device_ms']} peak_gb "
                      f"{m['peak_gb']:.2f}"
                      + (f" K5-raw in-frame ms {m['raw_in_frame_ms']:.4f}"
                         if m["raw_in_frame_ms"] else ""))
            print(f"[{case}] rank 0 device ms per frame by stage (the "
                  f"collectives' copies and waits under the stage that "
                  f"launches them): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in ranks[0][case][
                          "stages"].items()))
            imgs = ranks[0][case]["imgs"]
            if scene_name == "layered_mmark":
                def u8(a):
                    return layered_rgba8(torch.from_numpy(a)).numpy()
            else:
                u8 = to_rgba8
            for b, seed in enumerate(seeds):
                ref = refs[(case, seed)]
                img = imgs[b]
                if img.shape != ref.shape or not np.isfinite(img).all():
                    fail(f"[{case}] stitched frame {img.shape}, not finite "
                         f"or not {ref.shape}")
                got8, ref8 = u8(img), u8(ref)
                d8 = np.abs(got8.astype(np.int16) - ref8.astype(np.int16))
                print(f"[{case}] seed {seed}: stitched frame against the "
                      f"single-device frame: max abs "
                      f"{float(np.abs(img - ref).max())}, bytes differing "
                      f"{int((d8 != 0).sum())} of {d8.size}, max "
                      f"{int(d8.max())} levels")
                if d8.max() > 1:
                    fail(f"[{case}] seed {seed}: {int(d8.max())} levels "
                         f"from the single-device frame")
            raw = ranks[0][case].get("raw")
            if raw is not None:
                print(f"coverage_area_raw: max_abs_err {raw['max_abs_err']} "
                      f"kernel_ms {raw['ms']:.4f} profiled_ms "
                      f"{raw['profiled_ms']} (the trace kept {raw['kept']} "
                      f"of {raw['launched']} kernels) in_frame_profiled_ms "
                      f"{ranks[0][case]['raw_in_frame_ms']} plain_ms "
                      f"{raw['plain_ms']:.4f} bound_ms {raw['bound_ms']:.4f} "
                      f"({raw['bound_by']}) library_ms None launches "
                      f"{raw['launches']} ({case} rank 0) shape "
                      f"{raw['shape']} work {raw['work']}")
                raw_entry = {
                    "name": "coverage_area_raw", "route": "cuda",
                    "source": "vello_tpu_torch/csrc/coverage_area.cu",
                    "replaces": "vello_tpu/ops/pallas_kernels.py:84",
                    "launches": raw["launches"],
                    "max_abs_err": raw["max_abs_err"], "ms": raw["ms"],
                    "plain_ms": raw["plain_ms"], "bound_ms": raw["bound_ms"],
                    "bound_by": raw["bound_by"], "library_ms": None}
    if raw_entry is None:
        fail("phase 7 did not hold coverage_area_raw to its plain version")
    return raw_entry


def picker_scene(vt, picker, size):
    """The emoji picker ``picker`` of PICKERS at ``size`` square, built
    through the public API of the package ``vt`` (the port here; its tests
    pass the JAX package too): ``Scene.draw_glyphs`` of each row,
    ``text.layout_text`` of the header."""
    import importlib
    text = importlib.import_module(f"{vt.__name__}.text")
    files, chars = PICKERS[picker]
    k = size / TEXT_SIZE
    s = vt.Scene()
    header = text.default_font()
    (s.draw_glyphs(header).font_size(22.0 * k).brush(vt.palette.WHITE)
     .draw(vt.Fill.NON_ZERO, text.layout_text(
         header, 22.0 * k, PICKER_HEADER, (16.0 * k, 40.0 * k))))
    fonts = [text.Font(os.path.join(PICKER_FONT_DIR, f)) for f in files]
    px, top = PICKER_PX * k, 64.0 * k
    pitch_x, pitch_y = size / PICKER_COLS, (size - top) / PICKER_ROWS
    for row in range(PICKER_ROWS):
        font = fonts[row * len(fonts) // PICKER_ROWS]
        glyphs = [text.Glyph(
            font.glyph_id(chars[(row * PICKER_COLS + col) % len(chars)]),
            col * pitch_x + (pitch_x - px) / 2, top + row * pitch_y
            + 0.88 * px) for col in range(PICKER_COLS)]
        s.draw_glyphs(font).font_size(px).draw(vt.Fill.NON_ZERO, glyphs)
    return s


def text_cell_scene(test_scenes, scene_name, size):
    """A phase 9 scene at ``size``: text_heavy with 40 lines at TEXT_SIZE
    (its defaults) and 20 below, text_scene, glyph_runs (raster for
    glyph_raster), or an emoji picker."""
    if scene_name in PICKERS:
        import vello_tpu_torch
        return picker_scene(vello_tpu_torch, scene_name, float(size))
    if scene_name == "text_heavy":
        return test_scenes.text_heavy(float(size),
                                      lines=40 if size >= TEXT_SIZE else 20)
    if scene_name == "text_scene":
        return test_scenes.text_scene(float(size))
    return test_scenes.glyph_runs(float(size),
                                  raster=scene_name == "glyph_raster")


def run_text_cell(cell, kernels, Renderer, RenderParams, resolve,
                  test_scenes):
    """One phase 9 cell at TEXT_SIZE through Renderer(device="cuda"): the
    host's tier, no retry, overflow 0, its kernels' launches; first-frame
    s, warm ms, Renderer.profile's stages, device ms, peak GB, the scene's
    build and resolve s; a picker's K7 or K6 held to its plain version.
    Returns its numbers and its f32 frame (held to the oracle by
    ``run_text``)."""
    from vello_tpu_torch.pipeline import layered
    from vello_tpu_torch.utils.profile import profile_stages
    scene_name, aa, used = TEXT_CELLS[cell]
    t0 = time.perf_counter()
    scene = text_cell_scene(test_scenes, scene_name, TEXT_SIZE)
    build_s = time.perf_counter() - t0
    params = RenderParams(TEXT_SIZE, TEXT_SIZE, base_color=BASE,
                          antialiasing=aa)
    t0 = time.perf_counter()
    rs = resolve(scene.encoding, params)
    resolve_s = time.perf_counter() - t0
    want_tier = rs.capacities(params).key()
    n_paths, n_segs = rs.n_paths, rs.n_segs
    expected = {name: int(name in used) for name in kernels.launches}
    is_layered = "composite_over" in used
    if is_layered:
        # K7 once per draws op with a non-empty path range
        plan = layered.build_layer_plan(rs)[1]
        expected["composite_over"] = layered.nonempty_draws(plan)
        ops = plan["op_tab"][:, 0]
        pushes = int((ops == layered.OP_PUSH).sum())
        pops = int((ops == layered.OP_POP).sum())
    del rs
    r = Renderer(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    img = r.render(scene, params)
    first_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    prof = r.last_profile
    print(f"[{cell}] {TEXT_SIZE}x{TEXT_SIZE} {aa}: build_s {build_s:.4f} "
          f"resolve_s {resolve_s:.4f} paths {n_paths} segments {n_segs} "
          f"first_frame_s {first_s:.4f} tier {prof['tier']} retries "
          f"{prof['retries']} n_live {prof['n_live']} launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if prof["retries"] != 0 or prof["tier"] != dict(zip(prof["tier"],
                                                        want_tier)):
        fail(f"[{cell}] tier {prof['tier']} / retries {prof['retries']}: "
             f"expected the host's tier {want_tier} and no retry")
    if prof["layered"] != is_layered:
        fail(f"[{cell}] layered {prof['layered']}")
    if launches != expected:
        fail(f"[{cell}] launches {launches} in one frame, expected "
             f"{expected}")
    if img.shape != (TEXT_SIZE, TEXT_SIZE, 4) or not np.isfinite(img).all():
        fail(f"[{cell}] image {img.shape}, not finite")
    frame = r.frame_thunk()
    _, overflow = frame()
    if int(overflow) != 0:
        fail(f"[{cell}] warm frame overflow {int(overflow)}")
    times = []
    for _ in range(WARM_FRAMES):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    warm = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    stages = r.profile(scene, params)
    in_frame = check_stages(cell, stages, r.last_profile["kernels"], used,
                            launches)
    device_ms = profile_stages(frame)["_total"]
    print(f"[{cell}] warm_ms_per_frame median {warm:.3f} min "
          f"{min(times):.3f} max {max(times):.3f} over {WARM_FRAMES} frames; "
          f"device_ms_per_frame {device_ms:.4f} busy share "
          f"{device_ms / warm:.3f}; peak_mem_gb {peak_gb:.2f}")
    print(f"[{cell}] Renderer.profile device ms per frame: "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + "; in-frame kernel ms per launch "
          + ", ".join(f"{k} {v:.4f}" for k, v in in_frame.items()))
    extra = {}
    if is_layered:
        # the pops (library torch), and K7: its largest draws op against
        # its plain version, its launches in the frame against the sum of
        # their bounds
        pops_ms = stages.get("s22_op_pop", 0.0)
        (kargs, _), bound_ms = capture_largest_over(kernels, frame)
        err = hold_exact(cell, "composite_over", kernels.composite_over,
                         kernels.composite_over_plain, kargs)
        k7_ms = in_frame["composite_over"] * launches["composite_over"]
        print(f"[{cell}] pushes {pushes} pops {pops}: the pops "
              f"{pops_ms:.4f} device ms per frame "
              f"({pops_ms / max(pops, 1):.4f} a pop, "
              f"{pops_ms / stages['_total']:.3f} of the frame); "
              f"composite_over: the largest draws op ({tuple(kargs[0].shape)}"
              f" src) max abs err {err} against its plain version; "
              f"{launches['composite_over']} launches, profiled kernel ms "
              f"per frame {k7_ms:.4f}, the sum of their bounds "
              f"{bound_ms:.4f} ms, share {bound_ms / k7_ms:.3f}")
        extra = {"pushes": pushes, "pops": pops, "pops_ms": pops_ms,
                 "composite_over": {"max_abs_err": err,
                                    "in_frame_ms": k7_ms,
                                    "bound_ms": bound_ms}}
    elif "composite_src" in used and cell in PICKERS:
        (kargs, kw), = capture_calls(kernels, frame,
                                     ["composite_src"]).values()
        err = hold_exact(cell, "composite_src", kernels.composite_src,
                         kernels.composite_src_plain, kargs, kw)
        bound_ms = bound("composite_src", kargs,
                         kernels.composite_src(*kargs, **kw))[0]
        print(f"[{cell}] composite_src: max abs err {err} against its plain "
              f"version on {tuple(kargs[0].shape)} src; in frame "
              f"{in_frame['composite_src']:.4f} ms, bound {bound_ms:.4f} ms")
        extra = {"composite_src": {"max_abs_err": err,
                                   "in_frame_ms": in_frame["composite_src"],
                                   "bound_ms": bound_ms}}
    if cell == "text_heavy":
        # the occlusion walk on the text page's inputs
        (kargs, kw), = capture_calls(kernels, frame,
                                     ["occlusion_los"]).values()
        err = hold_exact(cell, "occlusion_los", kernels.occlusion_los,
                         kernels.occlusion_los_plain, kargs, kw)
        ms = cuda_ms(lambda: kernels.occlusion_los(*kargs, **kw), 20)
        library_ms = cuda_ms(
            lambda: kernels.occlusion_los_plain(*kargs, **kw), 3)
        bound_ms, _, work = bound("occlusion_los", kargs,
                                  kernels.occlusion_los(*kargs, **kw))
        print(f"[{cell}] occlusion_los: max abs err {err} kernel_ms "
              f"{ms:.4f} in_frame_profiled_ms "
              f"{in_frame['occlusion_los']:.4f} bound_ms {bound_ms:.4f} "
              f"(bytes) share {bound_ms / ms:.3f} library_ms "
              f"{library_ms:.4f} work {work}")
        print_walk_shares(f"[{cell}] occlusion_los", work)
        extra = {"occlusion_los": {"max_abs_err": err, "ms": ms,
                                   "in_frame_ms": in_frame["occlusion_los"],
                                   "bound_ms": bound_ms,
                                   "library_ms": library_ms}}
    return {**extra, "aa": aa, "build_s": build_s, "resolve_s": resolve_s,
            "paths": n_paths, "segments": n_segs, "first_frame_s": first_s,
            "tier": prof["tier"], "launches": {k: v for k, v in
                                               launches.items() if v},
            "warm_ms": [warm, min(times), max(times)], "peak_gb": peak_gb,
            "device_ms": device_ms, "busy": device_ms / warm,
            "profile_stages_ms": stages,
            "in_frame_ms_per_launch": in_frame}, img


def oracle_frame(cell, size):
    """The port's oracle frame of a phase 9 cell at ``size`` square and its
    seconds, in a worker process of ``run_text`` that refuses the font
    packages before it imports the port."""
    for name in TEXT_PACKAGES:
        sys.modules[name] = None
    from vello_tpu_torch import RenderParams
    from vello_tpu_torch.oracle import OracleRenderer
    from vello_tpu_torch.scenes import test_scenes
    scene_name, aa, _ = TEXT_CELLS[cell]
    t0 = time.perf_counter()
    img = OracleRenderer().render(
        text_cell_scene(test_scenes, scene_name, size),
        RenderParams(size, size, base_color=BASE, antialiasing=aa))
    return img, time.perf_counter() - t0


def hold_exact(cell, name, kfn, pfn, kargs, kw=None) -> float:
    """A kernel's call from a phase 9 frame against its plain version on
    the same inputs (K7 on a copy of its buffer each): equal, or fail.
    Returns the max abs error (0.0)."""
    kw = kw or {}
    got = kfn(*fresh_args(name, kargs), **kw)
    ref = pfn(*fresh_args(name, kargs), **kw)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max()) if got.numel() \
        else 0.0
    if got.shape != ref.shape or err != 0.0:
        fail(f"[{cell}] {name}: max abs err {err} against its plain "
             f"version (expected 0: the same arithmetic in the same order)")
    return err


def run_text(kernels, Renderer, RenderParams, resolve):
    """Phase 9 (run by ``--text``, after the font packages were refused):
    the TEXT_CELLS at TEXT_SIZE, then each at TEXT_CHECK_SIZE within 1 u8
    level of the port's CPU frame, then text_scene(128.) against its
    golden. Returns {cell: numbers}."""
    from vello_tpu_torch.scenes import test_scenes
    from vello_tpu_torch.text import default_font
    font = default_font()
    print(f"[text] default font {os.path.relpath(font.path, REPO)}: "
          f"{font.sfnt.num_glyphs} glyphs, {len(font._cmap)} code points")
    cells, frames = {}, {}
    for cell in TEXT_CELLS:
        cells[cell], frames[cell] = run_text_cell(
            cell, kernels, Renderer, RenderParams, resolve, test_scenes)
    # each cell's frame against the port's oracle, the oracles in parallel
    # processes after the timed frames (which share no host time with
    # them); the oracle renders msaa by supersampling (centers on a 4x4
    # grid for msaa16), not by the 16-sample mask: an msaa cell takes the
    # bar of the two, SAMPLE_MASK_MEAN (phase 3), an area cell the corpus
    # bar
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    t0 = time.perf_counter()
    workers = min(len(TEXT_CELLS), os.cpu_count() or 1)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        oracles = dict(zip(TEXT_CELLS, pool.map(
            oracle_frame, TEXT_CELLS, [TEXT_SIZE] * len(TEXT_CELLS))))
    print(f"[text] the port's oracle frames of the {len(TEXT_CELLS)} cells "
          f"in {time.perf_counter() - t0:.1f} s ({workers} processes)")
    for cell, (ref, oracle_s) in oracles.items():
        bar = ORACLE_MEAN_TOL if TEXT_CELLS[cell][1] == "area" \
            else SAMPLE_MASK_MEAN
        omean = float(np.abs(frames[cell] - ref).mean())
        cells[cell]["oracle_mean_abs"] = omean
        print(f"[{cell}] oracle mean abs {omean} (bar {bar}, the oracle "
              f"{oracle_s:.1f} s)")
        if not omean < bar:
            fail(f"[{cell}] mean abs {omean} against the port's oracle, bar "
                 f"{bar}")
    del frames, oracles
    n = TEXT_CHECK_SIZE
    for cell, (scene_name, aa, _) in TEXT_CELLS.items():
        scene = text_cell_scene(test_scenes, scene_name, n)
        params = RenderParams(n, n, base_color=BASE, antialiasing=aa)
        gpu_img = Renderer(device="cuda").render_u8(scene, params)
        cpu_img = Renderer(device="cpu").render_u8(scene, params)
        diff = np.abs(gpu_img.astype(np.int16) - cpu_img.astype(np.int16))
        print(f"image_check {n}x{n} {cell} ({scene_name} {aa}): max diff "
              f"{int(diff.max())}, identical {float((diff == 0).mean()):.6f}")
        if diff.max() > 1:
            fail(f"{cell}: GPU and CPU images differ by {int(diff.max())} "
                 f"levels")
    img = Renderer(device="cuda").render(
        test_scenes.text_scene(128.0),
        RenderParams(128, 128, base_color=TEXT_GOLDEN_BASE))
    gmean, gmax = golden_diff("text_scene", img, png="text_scene.png")
    print(f"[text_scene 128x128] golden tests/snapshots/text_scene.png: mean "
          f"{gmean:.6f} (bar {GOLDEN_MEAN_TOL}) max {gmax * 255:.2f}/255 (bar "
          f"{GOLDEN_MAX_TOL * 255:.2f}/255)")
    if not (gmean < GOLDEN_MEAN_TOL and gmax < GOLDEN_MAX_TOL):
        fail(f"text_scene(128.): golden mean {gmean}, max {gmax}")
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in TEXT_PACKAGES)
    print(f"[text] font packages loaded in this process: {loaded}")
    if loaded:
        fail(f"phase 9 loaded {loaded}")
    return cells


def run_text_phase():
    """Phase 9: ``chip_smoke.py --text`` in its own process and session
    (its kernels built by phase 2; no path variable of this process passed
    on); its output is printed here. Fails on its failure or timeout."""
    env = {k: v for k, v in os.environ.items()
           if k not in (UNROLLED, SUPERSAMPLE)}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--text"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TEXT_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"phase 9 ran past {TEXT_TIMEOUT} s")
    print(out, end="")
    if proc.returncode != 0:
        print(err[-3000:])
        fail(f"phase 9 exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])["text"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler table of 3 warm frames of "
                         "each path")
    ap.add_argument("--text", action="store_true",
                    help="run phase 9 alone (the build if needed, then the "
                         "text cells), fontTools, matplotlib and PIL refused")
    args = ap.parse_args()
    if args.text:
        from importlib.util import find_spec
        print("[text] on this host: " + ", ".join(
            f"{name} {'imports' if find_spec(name) else 'is absent'}"
            for name in TEXT_PACKAGES) + "; phase 9 refuses all three")
        # before the port is imported: text must need none of them
        for name in TEXT_PACKAGES:
            sys.modules[name] = None

    # 1. environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    torch.cuda.set_device(0)

    from vello_tpu_torch import Renderer, RenderParams, resolve
    from vello_tpu_torch.ops import fine, kernels
    from vello_tpu_torch.scenes import test_scenes
    from vello_tpu_torch.utils.profile import stage

    if args.text:
        t0 = time.perf_counter()
        kernels.build()
        print(f"build_s {time.perf_counter() - t0:.3f} (skipped when built)")
        t0 = time.perf_counter()
        cells = run_text(kernels, Renderer, RenderParams, resolve)
        print(f"--text: the text cells and their checks in "
              f"{time.perf_counter() - t0:.3f} s")
        print(json.dumps({"text": cells}))
        return

    # 2. build
    t0 = time.perf_counter()
    kernels.build(force=True)
    print(f"build_s {time.perf_counter() - t0:.3f} (nvcc, "
          f"{len(kernels.SOURCES)} kernels in parallel)")
    for src in kernels.SOURCES:
        for line in kernels.ptxas_report[src].splitlines():
            if any(k in line for k in ("entry function", "spill", "Used")):
                print(f"ptxas {src}: {line.strip()}")

    # 3. the frame paths at full size
    scenes = {name: make_scene(test_scenes, name, COMPLEXITY, float(SIZE))
              for name in {scene for scene, _, _ in PATHS.values()}}
    frames, path_launches, images, profiles, in_frame = {}, {}, {}, {}, {}
    for path, (scene_name, _, _) in PATHS.items():
        (frames[path], path_launches[path], images[path], profiles[path],
         in_frame[path]) = run_path(path, kernels, Renderer, RenderParams,
                                    resolve, scenes[scene_name],
                                    args.profile)
    # the host cost of the stage ranges when no profiler records: one
    # flag test and a shared no-op context each
    n = 100000
    t0 = time.perf_counter()
    for _ in range(n):
        with stage("s02_flatten"):
            pass
    range_us = (time.perf_counter() - t0) / n * 1e6
    print(f"stage range host cost {range_us:.4f} us each with no profiler "
          f"recording; per frame: "
          + ", ".join(f"{p} {prof['stage_ranges']} ranges "
                      f"{prof['stage_ranges'] * range_us:.2f} us"
                      for p, prof in profiles.items()))
    # the unrolled formulation against the scan formulation, same scene:
    # the same bytes, and the scan frame's warm time beside the unrolled's
    scene_name, aa, _ = PATHS["layered_unrolled"]
    r_scan = Renderer(device="cuda")
    with path_env("layered"):
        scan_img = r_scan.render_u8(
            scenes[scene_name], RenderParams(SIZE, SIZE, base_color=BASE,
                                             antialiasing=aa))
    differ = int((scan_img != images["layered_unrolled"]).sum())
    print(f"[layered_unrolled] bytes differing from the scan frame of "
          f"{scene_name}: {differ} of {scan_img.size}")
    if differ:
        fail(f"layered_unrolled: {differ} bytes differ from the scan frame")
    scan_frame = r_scan.frame_thunk()
    scan_frame()
    times = []
    for _ in range(WARM_FRAMES):
        t0 = time.perf_counter()
        scan_frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[layered_unrolled] its scan frame: warm_ms_per_frame median "
          f"{statistics.median(times):.3f} min {min(times):.3f} max "
          f"{max(times):.3f} over {WARM_FRAMES} frames")
    del r_scan, scan_frame
    # the supersampled msaa16 frame (f32) against the sample-mask msaa16
    # frame of the same scene, and its render_u8 bytes against
    # utils.png.to_rgba8 of its own f32 frame
    from vello_tpu_torch.utils.png import to_rgba8
    p16 = render_params(RenderParams, "msaa16", SIZE)
    with path_env("msaa16"):
        mask_img = Renderer(device="cuda").render(scenes["filled_mmark"], p16)
    with path_env("msaa16_supersampled"):
        sup_img = Renderer(device="cuda").render(scenes["filled_mmark"], p16)
    d = np.abs(sup_img - mask_img)
    u8_differ = int((to_rgba8(sup_img)
                     != images["msaa16_supersampled"]).sum())
    print(f"[msaa16_supersampled] against the sample-mask msaa16 frame: "
          f"mean abs {float(d.mean())} max abs {float(d.max())} (bar: mean "
          f"< {SAMPLE_MASK_MEAN}); render_u8 bytes differing from "
          f"to_rgba8 of the f32 frame: {u8_differ}")
    if not (np.isfinite(sup_img).all() and d.mean() < SAMPLE_MASK_MEAN):
        fail(f"msaa16_supersampled: mean abs {float(d.mean())} from the "
             f"sample-mask frame, bar {SAMPLE_MASK_MEAN}")
    if u8_differ:
        fail(f"msaa16_supersampled: render_u8 differs from to_rgba8 of the "
             f"f32 frame in {u8_differ} bytes")
    del scenes, images, scan_img, mask_img, sup_img, d

    # 4. each kernel against its plain version, on its path's inputs
    captured = {}
    for path in PATHS:
        if path in ("layered", "layered_speed"):
            name = k7_counter(path)
            captured[name], frame_bound = capture_largest_over(
                kernels, frames[path], name)
            frame_share(path, name, frame_bound, in_frame, path_launches)
            continue
        if path == "layered_unrolled":
            captured["cumsum"], frame_bound = capture_largest_cumsum(
                kernels, frames[path])
            frame_share(path, "cumsum", frame_bound, in_frame,
                        path_launches)
            continue
        wrappers = {KERNELS[n][1] for n in KERNELS if KERNELS[n][5] == path}
        if not wrappers:
            continue
        calls = capture_calls(kernels, frames[path], sorted(wrappers))
        for name, spec in KERNELS.items():
            if spec[5] == path:
                captured[name] = calls[spec[1]]
    captured["msaa_coverage_mmark"] = capture_cell_msaa(kernels, Renderer,
                                                        RenderParams)
    if captured["flatten_stroke_rows"][0][0].shape[1] != 21:
        fail("the stroked frame gave K1 no stroke rows")
    if (captured["segment_prep_stroked"][0][5] is None
            or captured["segment_prep"][0][5] is not None):
        fail("the segment preparation's stroke columns: expected on the "
             "stroked frame only")
    for path in CENTERS_PATHS:
        if captured[f"coverage_area_{path}"][0][5] is not True:
            fail(f"the {path} frame did not run K5 with its centers "
                 f"threshold")
    for name in ("composite_src_bf16", "composite_over_bf16"):
        if captured[name][0][0].dtype != torch.bfloat16:
            fail(f"{name}: the speed frame gave it "
                 f"{captured[name][0][0].dtype} src")
    # K8 at the layered cell's live tier: (n_live, 256) uniform values
    n_live = profiles["layered"]["n_live"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    captured["cumsum_layered_tier"] = ((torch.rand(
        (n_live, 256), generator=gen, device="cuda"),), {})
    results = []
    for name, (counter, wrapper, plain, source, replaces,
               path) in KERNELS.items():
        kargs, kw = captured[name]
        kfn = getattr(kernels, wrapper)
        pfn = getattr(kernels, plain, None) or getattr(fine, plain)
        got = kfn(*fresh_args(name, kargs), **kw)
        ref = pfn(*fresh_args(name, kargs), **kw)
        torch.cuda.synchronize()
        err = compare(name, got, ref)
        del got, ref
        targs = fresh_args(name, kargs)
        ms = cuda_ms(lambda: kfn(*targs, **kw), 20)
        kernel_prof_ms, kept, launched = profiled_ms(
            counter, lambda: kfn(*targs, **kw), 5)
        pargs = fresh_args(name, kargs)
        plain_ms = cuda_ms(lambda: pfn(*pargs, **kw), 3)
        del targs, pargs
        bound_ms, bound_by, work = bound(name, kargs,
                                         kfn(*fresh_args(name, kargs), **kw))
        launches = path_launches[path][counter]
        # torch.cumsum is the one PyTorch call that computes K8's
        # function; the occlusion walk's plain version is the library chain
        # (amin, cummax, gather, clamp) that the frame ran before
        library_ms = (cuda_ms(lambda: torch.cumsum(kargs[0], 0), 3)
                      if counter == "cumsum" else plain_ms
                      if counter == "occlusion_los" else None)
        # in-frame: the frame's launches of this kernel, per launch (K7:
        # the mean of the plan's draws ops; the layered-tier K8 and the
        # benchmark cell's K3 run in no frame of phase 3)
        frame_ms = (None if name in ("cumsum_layered_tier",
                                     "msaa_coverage_mmark")
                    else in_frame[path][counter])
        print(f"{name}: max_abs_err {err} kernel_ms {ms:.4f} profiled_ms "
              f"{kernel_prof_ms} (the trace kept {kept} of {launched} "
              f"kernels) in_frame_profiled_ms {frame_ms} "
              f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} "
              f"({bound_by}) library_ms {library_ms} launches {launches} "
              f"({path} frame) shape {tuple(kargs[0].shape)} work {work}")
        if counter == "occlusion_los":
            print_walk_shares(name, work)
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})

    print("occlusion_los: synced warm ms a frame (phase 3), the layered "
          "frame bypassing the walk: " + ", ".join(
              f"{p} {profiles[p]['summary']['warm_ms'][0]:.3f}"
              for p in ("msaa16", "stroked", "gradient_image", "layered")))

    # K8 at the live tier on multiples of 1/16 (every prefix exact), and
    # how far torch.cumsum (f32 on the card) is from the plain version
    x = captured["cumsum_layered_tier"][0][0]
    x16 = torch.floor(x * 16.0) / 16.0
    if not torch.equal(kernels.cumsum0(x16), kernels.cumsum0_plain(x16)):
        fail("cumsum_layered_tier: K8 differs from its plain version on "
             "multiples of 1/16")
    ref = kernels.cumsum0_plain(x)
    lib_err = float((torch.cumsum(x, 0) - ref).abs().max())
    print(f"cumsum_layered_tier: equal to the plain version on multiples "
          f"of 1/16; torch.cumsum max abs err {lib_err} against the plain "
          f"version (largest prefix {float(ref.abs().max())})")
    del x, x16, ref

    # the paint evaluation (library PyTorch) on the gradient frame's inputs
    (pargs, pkw), = capture_calls(fine, frames["gradient_image"],
                                  ["eval_paints"]).values()
    paint_ms = cuda_ms(lambda: fine.eval_paints(*pargs, **pkw), 5)
    print(f"eval_paints: ms {paint_ms:.4f} on {pargs[0].shape[0]} "
          f"fragments (gradient_image frame)")
    del frames, captured, pargs, pkw

    # 5. smaller frames: GPU kernels against the port's CPU plain path;
    # the supersampled paths at SUPERSAMPLED_CHECK, also held to the port's
    # oracle
    from vello_tpu_torch.oracle import OracleRenderer

    def check_shape(path, scene_name):
        """(complexity, size) of a path's phase 5 frame."""
        if path.endswith("_supersampled"):
            return SUPERSAMPLED_CHECK
        return (1 if scene_name == "layered_mmark" else 4), 512
    checks = []
    for path, (scene_name, aa, _) in PATHS.items():
        depth, n = check_shape(path, scene_name)
        checks.append((path, scene_name, aa, make_scene(
            test_scenes, scene_name, depth, float(n))))
    checks.append(("layer_features", "layer_features", "msaa16",
                   layer_features(512.0)))
    for path, scene_name, aa, small in checks:
        n = (check_shape(path, scene_name)[1] if path in PATHS else 512)
        sp = (RenderParams(512, 512, base_color=BASE, antialiasing=aa)
              if path == "layer_features"
              else render_params(RenderParams, path, n))
        with path_env(path):
            gpu_img = Renderer(device="cuda").render_u8(small, sp)
            cpu_img = Renderer(device="cpu").render_u8(small, sp)
            if path.endswith("_supersampled"):
                gpu_f32 = Renderer(device="cuda").render(small, sp)
                omean = float(np.abs(gpu_f32 - OracleRenderer().render(
                    small, sp)).mean())
        diff = np.abs(gpu_img.astype(np.int16) - cpu_img.astype(np.int16))
        print(f"image_check {n}x{n} {path} ({scene_name} {aa} "
              f"{sp.render_mode}): max diff "
              f"{int(diff.max())}, identical "
              f"{float((diff == 0).mean()):.6f}"
              + (f"; oracle mean abs {omean} (bar {ORACLE_MEAN_TOL})"
                 if path.endswith("_supersampled") else ""))
        if diff.max() > 1:
            fail(f"{path}: GPU and CPU images differ by {int(diff.max())} "
                 f"levels")
        if path.endswith("_supersampled") and not omean < ORACLE_MEAN_TOL:
            fail(f"{path}: {n}x{n} frame {omean} mean abs from the port's "
                 f"oracle, bar {ORACLE_MEAN_TOL}")

    # 6. the device probe and the reference corpus
    t0 = time.perf_counter()
    check_probe(Renderer)
    corpus = run_corpus(kernels, Renderer, RenderParams, resolve)
    print(f"phase 6: the probe and {len(corpus)} reference scenes in "
          f"{time.perf_counter() - t0:.3f} s; the largest by device ms: "
          + ", ".join(f"{n} {t[2]:.4f}" for n, t in sorted(
              corpus.items(), key=lambda kv: -kv[1][2])[:3]))

    # 7. the mesh, its ranks sharing the card
    t0 = time.perf_counter()
    results.append(run_mesh(Renderer, RenderParams, test_scenes))
    print(f"phase 7: the mesh in {time.perf_counter() - t0:.3f} s")

    # 8. the port's bench at its defaults, in a subprocess
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench_line = run_bench(path_launches, profiles)
    print(f"phase 8: the bench in {time.perf_counter() - t0:.3f} s")

    # 9. text, in a process that refuses the font packages
    t0 = time.perf_counter()
    run_text_phase()
    print(f"phase 9: text in {time.perf_counter() - t0:.3f} s")

    if args.profile:
        # phase 3's per-path numbers once more, after the profiler tables,
        # so that they stay in the output's tail
        summary = {p: prof["summary"] for p, prof in profiles.items()}
        with open(os.path.join(args.profile, "phase3_summary.json"),
                  "w") as f:
            json.dump(summary, f)
        print(json.dumps({"phase3": summary}))
    print(bench_line)
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
