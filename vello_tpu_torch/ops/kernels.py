"""The hand-written CUDA kernels of the frame, each beside its
plain PyTorch version (counterpart of ``vello_tpu/ops/pallas_kernels.py``).

- K1 flatten: ``flatten_lines`` (``csrc/flatten.cu``), plain
  ``flatten_lines_plain``;
- K2 touch expansion: ``expand_touches`` (``csrc/expand_touches.cu``),
  plain ``expand_touches_plain``;
- K3 msaa coverage: ``msaa_coverage`` (``csrc/msaa_coverage.cu``), plain
  ``fine.msaa_coverage_plain``;
- K4 solid composite: ``composite_solid`` (``csrc/composite_solid.cu``),
  plain ``fine.composite_solid_plain``;
- K5 area coverage: ``coverage_area`` (``csrc/coverage_area.cu``), plain
  ``fine.coverage_area_plain``; its raw per-fragment sums for the sharded
  area path: ``coverage_area_raw`` (the same source), plain
  ``fine.coverage_area_raw_plain``;
- K6 src composite: ``composite_src`` (``csrc/composite_src.cu``), plain
  ``fine.composite_src_plain``, on f32 or bf16 src (render_mode "speed");
- K7 layered draws op: ``composite_over`` (``csrc/composite_over.cu``),
  plain ``fine.composite_over_plain``, on f32 or bf16 src;
- K8 column cumsum: ``cumsum0`` (``csrc/cumsum.cu``), plain
  ``cumsum0_plain``;
- the fused geometry's segment preparation, before K1: ``segment_prep``
  (``csrc/segment_prep.cu``), plain ``segment_prep_plain``;
- the occlusion walk's starts, before K4 and K6: ``occlusion_los``
  (``csrc/composite_solid.cu``), plain ``occlusion_los_plain``.

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches the kernel on the current stream or raises; there is no other
fallback. The sources build with ``nvcc`` into one shared library with a
plain C interface (``build/libvello_kernels.so``) the first time a CUDA
tensor reaches a wrapper (the build and load are the host span
``vt.kernels_load``), so importing this module needs neither CUDA nor
``nvcc``. ``launches`` counts the kernel launches of each wrapper (K6 and
K7 count their bf16 instantiations apart, as ``composite_src_bf16`` and
``composite_over_bf16``, and K5 its raw entry as ``coverage_area_raw``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from ..encoding.config import (FLATTEN_TOL, MAX_LINES_PER_SEG, TILE_H,
                               TILE_W)
from .fine import (NPX, composite_over_plain, composite_solid_plain,
                   composite_src_plain, coverage_area_plain,
                   coverage_area_raw_plain, msaa_coverage_plain)
from ..utils.profile import Span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD, "libvello_kernels.so")
SOURCES = ("flatten.cu", "expand_touches.cu", "msaa_coverage.cu",
           "composite_solid.cu", "coverage_area.cu", "composite_src.cu",
           "composite_over.cu", "cumsum.cu", "segment_prep.cu")
# --fmad=false: no a*b+c contraction, so the geometry kernels round every
# op as the plain versions and the JAX package do (their floors must agree
# with the host estimator); IEEE division and sqrt are nvcc's defaults.
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills (kept in ``ptxas_report``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

# Keeps clamped verticals strictly inside the viewport (the JAX package's
# _EDGE_EPS: far below the u8 quantum, exact next to widths up to 8192).
EDGE_EPS = 2.0 ** -10
DUMP_TILE = 2 ** 30
ONE_MINUS_ULP = 0.99999994
ROBUST_EPS = 2e-7


def _span(a, b):
    return torch.clamp_min(torch.ceil(torch.maximum(a, b))
                           - torch.floor(torch.minimum(a, b)), 1.0)


def _dda_from_q(qx0, qy0, qx1, qy1) -> dict:
    """Staircase parameters of downward-oriented line endpoints: touch
    count, z(i) = floor(a*i + b) and the first tile. The same f32 op order
    as the JAX package's ``tiling._dda_from_q`` and kernels K1/K2."""
    sx0, sy0 = qx0 / TILE_W, qy0 / TILE_H
    sx1, sy1 = qx1 / TILE_W, qy1 / TILE_H
    count_x = _span(sx0, sx1) - 1.0
    count = count_x + _span(sy0, sy1)
    dx = torch.abs(sx1 - sx0)
    dy = sy1 - sy0
    denom = dx + dy
    zero_len = denom == 0.0
    boundary_horiz = (dy == 0.0) & (torch.floor(sy0) == sy0)
    idxdy = 1.0 / torch.where(zero_len, torch.ones_like(denom), denom)
    a = dx * idxdy
    pos_slope = sx1 >= sx0
    sign_x = torch.where(pos_slope, 1.0, -1.0)
    xt0 = torch.floor(sx0 * sign_x)
    c = sx0 * sign_x - xt0
    y0i = torch.floor(sy0)
    ytop = torch.where(sy0 == sy1, torch.ceil(sy0), y0i + 1.0)
    b = torch.clamp_max((dy * c + dx * (ytop - sy0)) * idxdy, ONE_MINUS_ULP)
    # robustness: force floor-consistency of the staircase's last step
    err = torch.floor(a * (count - 1.0) + b) - count_x
    a = torch.where(err != 0.0, a - ROBUST_EPS * torch.sign(err), a)
    x0i = xt0 * sign_x + torch.where(pos_slope, 0.0, -1.0)
    dead = zero_len | boundary_horiz
    return {
        "count": torch.where(dead, 0.0, count), "a": a, "b": b,
        "sign_x": sign_x, "x0i": x0i, "y0i": y0i, "sy0": sy0,
        "pos_slope": pos_slope,
    }


launches = {"flatten": 0, "expand_touches": 0, "msaa_coverage": 0,
            "composite_solid": 0, "coverage_area": 0,
            "coverage_area_raw": 0, "composite_src": 0,
            "composite_src_bf16": 0, "composite_over": 0,
            "composite_over_bf16": 0, "cumsum": 0, "segment_prep": 0,
            "occlusion_los": 0}

_lib = None

# source -> what ptxas reported when build() last compiled it
ptxas_report: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "vello_tpu_torch cannot be built")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into build/libvello_kernels.so (skipped when the
    library is newer than every source and header): one nvcc per source,
    all started together, then one link. Raises on a failed build."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    deps = srcs + [os.path.join(CSRC, "common.cuh")]
    if (not force and os.path.exists(LIB) and os.path.getmtime(LIB)
            >= max(os.path.getmtime(s) for s in deps)):
        return LIB
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in srcs:
        obj = os.path.join(BUILD, f"{os.path.basename(src)}.{tag}.o")
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, (obj, proc) in zip(SOURCES, jobs):
        out, err = proc.communicate()
        ptxas_report[src] = err
        if proc.returncode != 0:
            errors.append(f"{obj}: nvcc failed ({proc.returncode}):\n"
                          f"{out}\n{err}")
    tmp = f"{LIB}.{tag}"
    if not errors:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
             *(obj for obj, _ in jobs)], capture_output=True, text=True)
        if proc.returncode != 0:
            errors.append(f"link failed ({proc.returncode}):\n"
                          f"{proc.stdout}\n{proc.stderr}")
    for obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, LIB)
    return LIB


def _load():
    global _lib
    if _lib is None:
        with Span("vt.kernels_load"):
            lib = ctypes.CDLL(build())
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            L = ctypes.c_int64
            sigs = {
                "vt_flatten": [P, P, I, I, P, I, F, F, P],
                "vt_expand_touches": [P, P, I, P, I, P],
                "vt_msaa_coverage": [P, P, P, P, P, P, I, I, I, P, P],
                "vt_composite_solid": [P, P, P, P, P, I, P, P],
                "vt_coverage_area": [P, P, P, P, P, I, I, P, P],
                "vt_coverage_area_raw": [P, P, I, P, P],
                "vt_composite_src": [P, P, P, P, I, P, P],
                "vt_composite_src_bf16": [P, P, P, P, I, P, P],
                "vt_composite_over": [P, P, P, I, P, P],
                "vt_composite_over_bf16": [P, P, P, I, P, P],
                "vt_cumsum": [P, L, I, I, P, P, P],
                "vt_segment_prep": [P, P, P, P, P, P, P, P, P, P, I, P, P,
                                    I, I, F, F, F, P, P, P],
                "vt_segment_offsets": [P, P, P, I, I, P],
                "vt_occlusion_los": [P, P, P, I, F, P, P],
            }
            for name, argtypes in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _on_cpu(*ts) -> bool:
    """True for all-CPU tensors, False for all-CUDA tensors on the current
    device; anything else raises."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{dev} is not the current CUDA device")
    return False


def _check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _src_kernel(name: str, src) -> str:
    """The launch counter of K6 or K7 (``name``) for these src rows, which
    is also its C entry point without the ``vt_`` prefix: ``name`` for f32,
    ``name + "_bf16"`` for bf16 (render_mode "speed"); any other dtype
    raises."""
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"src: dtype {src.dtype}, expected torch.float32 "
                        f"or torch.bfloat16")
    return name + "_bf16" if src.dtype == torch.bfloat16 else name


def _check_rows_aligned(trow):
    """K3 and K5 read each 32-byte touch row as float4."""
    if trow.data_ptr() % 16:
        raise ValueError("trow must start on a 16-byte boundary")


def _call(name, fn, *args):
    """Call a C launcher with tensors passed as device pointers, on the
    current stream; raise on a failed launch. Under a profiler the call
    runs in an op-level range ``vt_<name>``: the profiler links a kernel to
    the op that launched it, and a user range such as a pipeline stage is
    not an op."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    if torch.autograd._profiler_enabled():
        with torch._C._profiler._RecordFunctionFast(f"vt_{name}"):
            rc = fn(*args, stream)
    else:
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _launch(name, fn, *args):
    """``_call``, and count the launch under ``name``."""
    _call(name, fn, *args)
    launches[name] += 1


# --------------------------------------------------------------------------
# K1: flatten (replaces pallas_kernels.flatten_pallas / _flatten_kernel)

def flatten_lines(spack, incl, n_lines: int, width: float, height: float):
    """spack (S, 16) f32 per segment [8 cubic coords, count, offs, rect6],
    or (S, 21) with the stroke columns [hw, jnx, jny, m, join] appended;
    incl (S,) i32 inclusive line-count scan. Line slot p belongs to the
    segment with offs <= p < incl and evaluates its cubic at t = sub/n and
    (sub+1)/n, or, for a stroked segment (m > 0), takes slot line
    (sub // 7, sub % 7) of ``flatten.stroke_slot_line``; then it trims y to
    [0, height], clamps x into the viewport and computes its DDA touch
    count. Slots at or past the total are dead. Returns the (16, L) line
    pack [qx0, qy0, qx1, qy1, down, tcount, live, crossing, ev_y0, ev_y1,
    rect6]."""
    if _on_cpu(spack, incl):
        return flatten_lines_plain(spack, incl, n_lines, width, height)
    hi = max(width - EDGE_EPS, EDGE_EPS + 1e-3)
    s = incl.shape[0]
    cols = spack.shape[1] if spack.dim() == 2 else 0
    if cols not in (16, 21):
        raise ValueError(f"spack: {cols} columns, expected 16 or 21")
    _check(spack, "spack", torch.float32, (s, cols))
    _check(incl, "incl", torch.int32, (s,))
    out = torch.empty((16, n_lines), dtype=torch.float32,
                      device=spack.device)
    if n_lines and s:
        _launch("flatten", _load().vt_flatten, spack, incl, s, cols, out,
                n_lines, hi, float(height))
    return out


def _gather_slots(pack_rows, incl, n_slots):
    """Rows of the source element owning each slot p (offs <= p < incl),
    zeros for slots at or past the total — what the Pallas kernels'
    one-hot window select yields."""
    p = torch.arange(n_slots, dtype=torch.int32, device=incl.device)
    idx = torch.searchsorted(incl, p, side="right", out_int32=True)
    idx = idx.clamp_max(incl.shape[0] - 1).long()
    rows = pack_rows[idx]
    return torch.where((p < incl[-1])[:, None], rows, 0.0), p


def flatten_lines_plain(spack, incl, n_lines: int, width: float,
                        height: float):
    """Plain version of K1 (same f32 op order as the kernel)."""
    hi = max(width - EDGE_EPS, EDGE_EPS + 1e-3)
    lo = EDGE_EPS
    r, p = _gather_slots(spack, incl, n_lines)
    f = r.T                                              # (16 | 21, L)
    c0x, c0y, c1x, c1y, c2x, c2y, c3x, c3y = f[0:8]
    n = torch.clamp_min(f[8], 1.0)
    rect = f[10:16]
    pfr = p.to(torch.float32)
    sub = pfr - f[9]
    t0 = sub / n
    t1 = (sub + 1.0) / n

    def ev(t, ca, cb, cc, cd):
        mt = 1.0 - t
        return (mt * mt * mt * ca + 3 * mt * mt * t * cb
                + 3 * mt * t * t * cc + t * t * t * cd)

    if f.shape[0] == 21:
        from .flatten import STROKE_SLOTS, stroke_slot_line
        is_st = f[19] > 0.5
        msafe = torch.clamp_min(f[19], 1.0)
        si = torch.floor((sub + 0.5) * (1.0 / STROKE_SLOTS))
        se = sub - STROKE_SLOTS * si
        t0 = torch.where(is_st, si / msafe, t0)
        t1 = torch.where(is_st, (si + 1.0) / msafe, t1)
    p0x = ev(t0, c0x, c1x, c2x, c3x)
    p0y = ev(t0, c0y, c1y, c2y, c3y)
    p1x = ev(t1, c0x, c1x, c2x, c3x)
    p1y = ev(t1, c0y, c1y, c2y, c3y)
    if f.shape[0] == 21:
        t2 = (si + 2.0) / msafe
        ax, ay, bx, by = stroke_slot_line(
            p0x, p0y, p1x, p1y, ev(t2, c0x, c1x, c2x, c3x),
            ev(t2, c0y, c1y, c2y, c3y), f[16], f[17], f[18], f[20], si, se,
            msafe)
        p0x = torch.where(is_st, ax, p0x)
        p0y = torch.where(is_st, ay, p0y)
        p1x = torch.where(is_st, bx, p1x)
        p1y = torch.where(is_st, by, p1y)
    zero = torch.zeros((), dtype=torch.float32, device=spack.device)
    one = torch.ones((), dtype=torch.float32, device=spack.device)

    # y trim (parametric; untrimmed endpoints stay bit-identical)
    y0, y1 = p0y, p1y
    dy = y1 - y0
    y0c = y0.clamp(0.0, height)
    y1c = y1.clamp(0.0, height)
    nzy = torch.abs(dy) > 1e-12
    inv_dy = torch.where(nzy, 1.0 / torch.where(nzy, dy, one), zero)
    ta = torch.where(nzy, (y0c - y0) * inv_dy, zero)
    tb = torch.where(nzy, (y1c - y0) * inv_dy, one)
    x0 = torch.where(y0c != y0, p0x + ta * (p1x - p0x), p0x)
    x1 = torch.where(y1c != y1, p0x + tb * (p1x - p0x), p1x)
    y0, y1 = y0c, y1c
    real = pfr < incl[-1].to(torch.float32)
    alive = real & (torch.abs(y1 - y0) + torch.abs(x1 - x0) > 1e-12)

    # x clamp + left-edge verticals
    x0c = x0.clamp(lo, hi)
    x1c = x1.clamp(lo, hi)
    dx = x1 - x0
    nzx = torch.abs(dx) > 1e-12
    inv_dx = torch.where(nzx, 1.0 / torch.where(nzx, dx, one), zero)
    u0 = torch.where(nzx, ((x0c - x0) * inv_dx).clamp(0.0, 1.0), zero)
    u1 = torch.where(nzx, ((x1c - x0) * inv_dx).clamp(0.0, 1.0), one)
    ye0 = y0 + u0 * (y1 - y0)
    ye1 = y0 + u1 * (y1 - y0)
    outside = (torch.maximum(x0, x1) <= lo) | (torch.minimum(x0, x1) >= hi)
    my0 = torch.where(outside | (x0c == x0), y0, ye0)
    my1 = torch.where(outside | (x1c == x1), y1, ye1)
    crossing = alive & nzx & (torch.minimum(x0, x1) < lo) \
        & (torch.maximum(x0, x1) > lo)
    need_start = crossing & (x0 < x1)
    ev_y0 = torch.where(need_start, y0, ye1)
    ev_y1 = torch.where(need_start, ye0, y1)

    # orientation + DDA touch count on the clamped line
    is_down = my1 >= my0
    qx0 = torch.where(is_down, x0c, x1c)
    qy0 = torch.where(is_down, my0, my1)
    qx1 = torch.where(is_down, x1c, x0c)
    qy1 = torch.where(is_down, my1, my0)
    count = _dda_from_q(qx0, qy0, qx1, qy1)["count"]
    on_right = torch.minimum(x0c, x1c) / TILE_W >= rect[2]
    live = alive & ~on_right & (rect[4] > 0.0) & (count > 0.0)
    return torch.cat([
        torch.stack([qx0, qy0, qx1, qy1, torch.where(is_down, one, -one),
                     torch.where(live, count, zero), live.to(torch.float32),
                     crossing.to(torch.float32), ev_y0, ev_y1]),
        rect], dim=0).contiguous()


# --------------------------------------------------------------------------
# K2: touch expansion (replaces expand_touches_pallas /
# _expand_touch_kernel)

def expand_touches(lpack, incl, n_touches: int):
    """lpack (16, N) f32 per line [qx0, qy0, qx1, qy1, down, offs, incl,
    live, tx0, ty0, tx1, ty1, stride, base, 0, 0]; incl (N,) i32 inclusive
    touch-count scan. Touch slot p belongs to the line with offs <= p <
    incl and is step i = p - offs of its DDA staircase. Returns the (8, T)
    payload [s0x, s0y, s1x, s1y, y_edge, backdrop, ftile, 0]: the segment
    clipped to its tile in tile-local coordinates, the left-edge y, the
    top-edge backdrop delta and the flat tile id (DUMP_TILE for dead
    slots, whose coordinates are 0 and y_edge 1e9)."""
    if _on_cpu(lpack, incl):
        return expand_touches_plain(lpack, incl, n_touches)
    n = incl.shape[0]
    _check(lpack, "lpack", torch.float32, (16, n))
    _check(incl, "incl", torch.int32, (n,))
    pay = torch.empty((8, n_touches), dtype=torch.float32,
                      device=lpack.device)
    if n_touches and n:
        _launch("expand_touches", _load().vt_expand_touches, lpack, incl, n,
                pay, n_touches)
    return pay


def expand_touches_plain(lpack, incl, n_touches: int):
    """Plain version of K2 (same f32 op order as the kernel)."""
    r, p = _gather_slots(lpack.T, incl, n_touches)
    f = r.T                                              # (16, T)
    qx0, qy0, qx1, qy1, down, offs = f[0:6]
    live = f[7]
    tx0, ty0, tx1, ty1, stride, base = f[8:14]
    dev = lpack.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    pfr = p.to(torch.float32)
    i = pfr - offs

    # DDA staircase: step i of the line's tile walk. (The dead-line count
    # of 0 differs from the kernel's raw count only on lanes tvalid masks:
    # a dead line is never live.)
    d = _dda_from_q(qx0, qy0, qx1, qy1)
    a, b, sign_x, pos_slope = d["a"], d["b"], d["sign_x"], d["pos_slope"]
    z = torch.floor(a * i + b)
    x = torch.minimum(torch.maximum(d["x0i"] + sign_x * z, tx0), tx1 - 1.0)
    y = torch.minimum(torch.maximum(d["y0i"] + i - z, ty0), ty1 - 1.0)
    tvalid = (pfr < incl[-1].to(torch.float32)) & (live > 0.0)
    ftile = torch.where(tvalid, base + (y - ty0) * stride + (x - tx0),
                        float(DUMP_TILE))

    # backdrop: a top-edge entry targets tile x+1
    z_prev = torch.floor(a * (i - 1.0) + b)
    top_edge = torch.where(i == 0.0, torch.floor(d["sy0"]) == d["sy0"],
                           z == z_prev)
    b_ok = tvalid & top_edge & (x + 1.0 < tx1)
    backdrop = torch.where(b_ok, torch.where(down > 0.0, -one, one), zero)

    # clip the segment to the tile (path_tiling rules)
    tile_x = x * TILE_W
    tile_y = y * TILE_H
    tile_x1 = tile_x + TILE_W
    tile_y1 = tile_y + TILE_H
    dxl = qx1 - qx0
    dyl = qy1 - qy0
    inv_dyl = 1.0 / torch.where(dyl == 0.0, one, dyl)
    inv_dxl = 1.0 / torch.where(dxl == 0.0, one, dxl)

    def clip(v, lo_, hi_):
        return torch.minimum(torch.maximum(v, lo_), hi_)

    z_same_prev = z == z_prev
    xt_top = clip(qx0 + dxl * (tile_y - qy0) * inv_dyl, tile_x + 1e-3,
                  tile_x1)
    x_clip_e = torch.where(pos_slope, tile_x, tile_x1)
    yt_side = clip(qy0 + dyl * (x_clip_e - qx0) * inv_dxl, tile_y + 1e-3,
                   tile_y1)
    px0 = torch.where(i > 0.0, torch.where(z_same_prev, xt_top, x_clip_e),
                      qx0)
    py0 = torch.where(i > 0.0, torch.where(z_same_prev, tile_y, yt_side),
                      qy0)
    z_same_next = z == torch.floor(a * (i + 1.0) + b)
    xt_bot = clip(qx0 + dxl * (tile_y1 - qy0) * inv_dyl, tile_x + 1e-3,
                  tile_x1)
    x_clip_x = torch.where(pos_slope, tile_x1, tile_x)
    yt_side2 = clip(qy0 + dyl * (x_clip_x - qx0) * inv_dxl, tile_y + 1e-3,
                    tile_y1)
    last = i >= d["count"] - 1.0
    px1 = torch.where(last, qx1, torch.where(z_same_next, xt_bot, x_clip_x))
    py1 = torch.where(last, qy1, torch.where(z_same_next, tile_y1,
                                             yt_side2))

    # tile-local coordinates + robustness rules (path_tiling.wgsl)
    p0x = px0 - tile_x
    p0y = py0 - tile_y
    p1x = px1 - tile_x
    p1y = py1 - tile_y
    eps = 1e-6
    y_edge = torch.full_like(p0x, 1e9)
    both0 = (p0x == 0.0) & (p1x == 0.0)
    entire = both0 & (p0y == 0.0)
    vanish = both0 & (p0y != 0.0)
    p0_only = (p0x == 0.0) & (p1x != 0.0)
    y_edge = torch.where(p0_only & (p0y != 0.0), p0y, y_edge)
    y_edge = torch.where((p1x == 0.0) & ~both0 & (p1y != 0.0), p1y, y_edge)
    p0x = torch.where(both0 | (p0_only & (p0y == 0.0)), eps, p0x)
    p1x = torch.where(entire, eps, torch.where(vanish, 2 * eps, p1x))
    p1y = torch.where(entire, float(TILE_H), torch.where(vanish, p0y, p1y))
    p1x = torch.where((p1x == 0.0) & (p1y == 0.0) & ~both0, eps, p1x)
    p0x = torch.where((p0x == torch.floor(p0x)) & (p0x != 0.0), p0x - eps,
                      p0x)
    p1x = torch.where((p1x == torch.floor(p1x)) & (p1x != 0.0), p1x - eps,
                      p1x)
    is_down = down > 0.0
    seg = [torch.where(is_down, p0x, p1x), torch.where(is_down, p0y, p1y),
           torch.where(is_down, p1x, p0x), torch.where(is_down, p1y, p0y)]
    return torch.stack(
        [torch.where(tvalid, v, zero) for v in seg]
        + [torch.where(tvalid, y_edge, 1e9), backdrop, ftile,
           torch.zeros_like(ftile)]).contiguous()


# --------------------------------------------------------------------------
# K3: msaa coverage (replaces msaa_coverage_pallas / _msaa_cov_kernel +
# _msaa_block, and the coverage assembly around them)

def msaa_coverage(trow, starts, fidx, backdrop, rule, valid, ns: int,
                  has_evenodd: bool = True):
    """Coverage rows (N, 256) f32 of fragments fidx (see
    ``fine.msaa_coverage_plain``). trow (T, 8) f32 fragment-sorted
    touches; starts (F+1,) i32; fidx (N,) i32; backdrop (F,) f32; rule
    (F,) i32; valid (F,) bool."""
    if ns not in (8, 16):
        raise ValueError(f"ns must be 8 or 16, got {ns}")
    if _on_cpu(trow, starts, fidx, backdrop, rule, valid):
        return msaa_coverage_plain(trow, starts, fidx, backdrop, rule,
                                   valid, ns, has_evenodd)
    f = backdrop.shape[0]
    n = fidx.shape[0]
    _check(trow, "trow", torch.float32, (trow.shape[0], 8))
    _check(starts, "starts", torch.int32, (f + 1,))
    _check(fidx, "fidx", torch.int32, (n,))
    _check(backdrop, "backdrop", torch.float32, (f,))
    _check(rule, "rule", torch.int32, (f,))
    _check(valid, "valid", torch.bool, (f,))
    _check_rows_aligned(trow)
    out = torch.empty((n, NPX), dtype=torch.float32, device=trow.device)
    if n:
        _launch("msaa_coverage", _load().vt_msaa_coverage, trow, starts,
                fidx, backdrop, rule, valid, n, ns, int(has_evenodd), out)
    return out


# --------------------------------------------------------------------------
# K4: solid composite (replaces fine_composite_solid_cov / _fine_cov_kernel)

def composite_solid(cov, col, base_premul, los, his):
    """Ordered src-over per tile of fragments [los[g], his[g]) onto the
    premultiplied base (see ``fine.composite_solid_plain``). cov (F, 256)
    f32, col (F, 4) f32 premultiplied, base_premul (4,) f32, los/his (G,)
    i32 -> (G, 4, 256) f32."""
    if _on_cpu(cov, col, base_premul, los, his):
        return composite_solid_plain(cov, col, base_premul, los, his)
    f = cov.shape[0]
    g = los.shape[0]
    _check(cov, "cov", torch.float32, (f, NPX))
    _check(col, "col", torch.float32, (f, 4))
    _check(base_premul, "base_premul", torch.float32, (4,))
    _check(los, "los", torch.int32, (g,))
    _check(his, "his", torch.int32, (g,))
    out = torch.empty((g, 4, NPX), dtype=torch.float32, device=cov.device)
    if g:
        _launch("composite_solid", _load().vt_composite_solid, cov, col,
                base_premul, los, his, g, out)
    return out


# --------------------------------------------------------------------------
# K5: area coverage (replaces coverage_cumsum_pallas / _cov_kernel, and the
# cumsum differencing, fill rule and centers threshold around it)

def coverage_area(trow, starts, backdrop, rule, valid, centers: bool):
    """Area coverage rows (F, 256) f32 of every fragment (see
    ``fine.coverage_area_plain``). trow (T, 8) f32 fragment-sorted
    touches; starts (F+1,) i32; backdrop (F,) f32; rule (F,) i32; valid
    (F,) bool."""
    if _on_cpu(trow, starts, backdrop, rule, valid):
        return coverage_area_plain(trow, starts, backdrop, rule, valid,
                                   centers)
    f = backdrop.shape[0]
    _check(trow, "trow", torch.float32, (trow.shape[0], 8))
    _check(starts, "starts", torch.int32, (f + 1,))
    _check(backdrop, "backdrop", torch.float32, (f,))
    _check(rule, "rule", torch.int32, (f,))
    _check(valid, "valid", torch.bool, (f,))
    _check_rows_aligned(trow)
    out = torch.empty((f, NPX), dtype=torch.float32, device=trow.device)
    if f:
        _launch("coverage_area", _load().vt_coverage_area, trow, starts,
                backdrop, rule, valid, f, int(centers), out)
    return out


def coverage_area_raw(trow, starts):
    """K5's raw entry: each fragment's summed ``coverage_delta`` rows
    (F, 256) f32, with no backdrop, fill rule, centers threshold or valid
    mask (see ``fine.coverage_area_raw_plain``): the partial sums that the
    sharded area path all-reduces. trow (T, 8) f32 fragment-sorted
    touches; starts (F+1,) i32."""
    if _on_cpu(trow, starts):
        return coverage_area_raw_plain(trow, starts)
    f = starts.shape[0] - 1
    _check(trow, "trow", torch.float32, (trow.shape[0], 8))
    _check(starts, "starts", torch.int32, (f + 1,))
    _check_rows_aligned(trow)
    out = torch.empty((f, NPX), dtype=torch.float32, device=trow.device)
    if f:
        _launch("coverage_area_raw", _load().vt_coverage_area_raw, trow,
                starts, f, out)
    return out


# --------------------------------------------------------------------------
# K6: src composite (replaces fine_composite_solid / _fine_kernel)

def composite_src(src, base_premul, los, his):
    """Ordered src-over per tile of the premultiplied src rows [los[g],
    his[g]) onto the premultiplied base (see ``fine.composite_src_plain``).
    src (F, 4, 256) f32, or bf16 (render_mode "speed": each value widened
    to f32, the arithmetic f32), base_premul (4,) f32, los/his (G,) i32 ->
    (G, 4, 256) f32."""
    kernel = _src_kernel("composite_src", src)
    if _on_cpu(src, base_premul, los, his):
        return composite_src_plain(src, base_premul, los, his)
    f = src.shape[0]
    g = los.shape[0]
    _check(src, "src", src.dtype, (f, 4, NPX))
    _check(base_premul, "base_premul", torch.float32, (4,))
    _check(los, "los", torch.int32, (g,))
    _check(his, "his", torch.int32, (g,))
    out = torch.empty((g, 4, NPX), dtype=torch.float32, device=src.device)
    if g:
        _launch(kernel, getattr(_load(), f"vt_{kernel}"), src, base_premul,
                los, his, g, out)
    return out


# --------------------------------------------------------------------------
# K7: layered draws op (replaces fine_composite_over / _fine_kernel_over)

def composite_over(src, dst, los, his):
    """Ordered src-over per tile of the premultiplied src rows [los[g],
    his[g]) onto the tile's current value in ``dst``, IN PLACE (see
    ``fine.composite_over_plain``): tiles with an empty walk are neither
    read nor written. src (F, 4, 256) f32, dst (G, 4, 256) f32, los/his
    (G,) i32. src may be bf16 (render_mode "speed"): each value is widened
    to f32, and dst and the arithmetic stay f32. Returns dst."""
    kernel = _src_kernel("composite_over", src)
    if _on_cpu(src, dst, los, his):
        return composite_over_plain(src, dst, los, his)
    g = los.shape[0]
    _check(src, "src", src.dtype, (src.shape[0], 4, NPX))
    _check(dst, "dst", torch.float32, (g, 4, NPX))
    _check(los, "los", torch.int32, (g,))
    _check(his, "his", torch.int32, (g,))
    if g:
        _launch(kernel, getattr(_load(), f"vt_{kernel}"), src, los, his, g,
                dst)
    return dst


# --------------------------------------------------------------------------
# K8: column cumsum (replaces cumsum_pallas / _cumsum_kernel)

# rows per block of csrc/cumsum.cu's three passes; the block totals and
# carries take ceil(T / CUMSUM_ROWS) x C doubles of scratch
CUMSUM_ROWS = 64


def cumsum0(x):
    """Inclusive cumsum over axis 0 of a contiguous (T, C) f32 tensor, any
    T >= 0 and C >= 1 (see ``cumsum0_plain``)."""
    if _on_cpu(x):
        return cumsum0_plain(x)
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (T, C >= 1)")
    t, c = x.shape
    _check(x, "x", torch.float32, (t, c))
    nb = -(-t // CUMSUM_ROWS)
    if nb >= 2 ** 31 or c > 65535 * 128:
        raise ValueError(f"x: shape {(t, c)} exceeds the launch grid")
    out = torch.empty_like(x)
    if t:
        tot = torch.empty((nb, c), dtype=torch.float64, device=x.device)
        _launch("cumsum", _load().vt_cumsum, x, t, c, CUMSUM_ROWS, tot, out)
    return out


def cumsum0_plain(x):
    """Plain version of K8: every prefix summed in f64 and rounded to f32
    once. On the CPU this is torch.cumsum(x, 0) bit for bit (it accumulates
    f32 in f64); on the card torch.cumsum accumulates in f32."""
    return torch.cumsum(x, 0, dtype=torch.float64).to(x.dtype)


# --------------------------------------------------------------------------
# The fused geometry's segment preparation (no TPU kernel: the JAX
# package's XLA fuses the same segment-scale chain)

# the f32 constants of the Wang and turning-angle bounds at FLATTEN_TOL:
# PyTorch on CUDA divides a tensor by a Python scalar as a multiply by the
# scalar's f32 reciprocal (see csrc/segment_prep.cu)
_INV_8TOL = float(np.float32(1.0) / np.float32(8.0 * FLATTEN_TOL))
RECT_FIELDS = ("tx0", "ty0", "tx1", "ty1", "stride", "base")


def segment_prep(seg_pts, seg_kind, seg_path, n_segs, rects, seg_hw=None,
                 seg_join=None, max_lines: int = MAX_LINES_PER_SEG):
    """Host-compacted, transform-folded segments -> (spack (S, 16) f32, or
    (S, 21) with ``seg_hw``, incl (S,) i32): per segment [8 cubic coords,
    count, offs, rect6] and, with strokes, [hw, jnx, jny, m, join] (the
    pack ``flatten_lines`` reads), and the inclusive scan of the counts.
    seg_pts (S, 4, 2) f32, seg_kind/seg_path (S,) i32, n_segs one i32 (0-d
    or (1,); the segments at or past it count no lines), rects the
    per-path dict of ``tiling.tile_alloc`` (RECT_FIELDS, (P,) i32 each,
    P >= 1), seg_hw (S,) f32 half-widths (0 for a fill), seg_join (S,) i32
    (see ``segment_prep_plain``). On the card: one launch of the preparation,
    torch.cumsum of the counts, one launch writing offs = incl - counts;
    nothing is read back."""
    cols = [rects[k] for k in RECT_FIELDS]
    stroke = [] if seg_hw is None else [seg_hw, seg_join]
    if _on_cpu(seg_pts, seg_kind, seg_path, n_segs, *cols, *stroke):
        return segment_prep_plain(seg_pts, seg_kind, seg_path, n_segs,
                                  rects, seg_hw, seg_join, max_lines)
    s = seg_kind.shape[0]
    p = cols[0].shape[0]
    _check(seg_pts, "seg_pts", torch.float32, (s, 4, 2))
    _check(seg_kind, "seg_kind", torch.int32, (s,))
    _check(seg_path, "seg_path", torch.int32, (s,))
    if n_segs.dtype != torch.int32 or n_segs.numel() != 1:
        raise ValueError(f"n_segs: {n_segs.dtype} {tuple(n_segs.shape)}, "
                         f"expected one int32")
    for k, t in zip(RECT_FIELDS, cols):
        _check(t, k, torch.int32, (p,))
    if seg_hw is not None:
        _check(seg_hw, "seg_hw", torch.float32, (s,))
        _check(seg_join, "seg_join", torch.int32, (s,))
    width = 16 if seg_hw is None else 21
    counts = torch.empty(s, dtype=torch.int32, device=seg_pts.device)
    spack = torch.empty((s, width), dtype=torch.float32,
                        device=seg_pts.device)
    if not s:
        return spack, counts
    lib = _load()
    _launch("segment_prep", lib.vt_segment_prep, seg_pts, seg_kind, seg_path,
            n_segs, *cols, p, seg_hw, seg_join, s, max_lines, _INV_8TOL,
            FLATTEN_TOL, 8.0 * FLATTEN_TOL, counts, spack)
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    _call("segment_prep", lib.vt_segment_offsets, counts, incl, spack, s,
          width)
    return spack, incl


def segment_prep_plain(seg_pts, seg_kind, seg_path, n_segs, rects,
                       seg_hw=None, seg_join=None,
                       max_lines: int = MAX_LINES_PER_SEG):
    """Plain version of the segment preparation: degree elevation, Wang
    counts and, with ``seg_hw``, stroke mini counts (7 lines per mini) and
    join normals (the NEXT segment's first-chord normal, where
    ``seg_join`` is set: the kernel's bevel corner then matches the next
    quad's), counts zeroed from ``n_segs`` on, their scan, and the path
    rects gathered per segment. On the card it rounds as the kernel does:
    a tensor divided by a Python scalar is a multiply by its reciprocal
    there."""
    from .flatten import _stroke_rows, elevate_to_cubic, wang_counts
    from .tiling import rect_pack
    cub = elevate_to_cubic(seg_pts, seg_kind)
    counts = wang_counts(cub, seg_kind, max_lines=max_lines)
    s = cub.shape[0]
    srows = []
    if seg_hw is not None:
        st_counts, is_stroke, scols = _stroke_rows(cub, seg_hw, seg_join,
                                                   max_lines)
        counts = torch.where(is_stroke, st_counts, counts)
        srows = [scols]
    live_seg = torch.arange(s, dtype=torch.int32, device=cub.device) < n_segs
    counts = torch.where(live_seg, counts, torch.zeros_like(counts))
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    offs = incl - counts
    rpack = rect_pack(rects)
    pclip = seg_path.long().clamp(0, rpack.shape[0] - 1)
    spack = torch.cat([
        cub.reshape(s, 8),
        counts.to(torch.float32)[:, None],
        offs.to(torch.float32)[:, None],
        rpack[pclip]] + srows, dim=1).contiguous()          # (S, 16 | 21)
    return spack, incl


# --------------------------------------------------------------------------
# The occlusion walk's starts (no TPU kernel: the JAX package's XLA runs a
# cummax over every fragment)

# a fragment fully covers its tile where all its coverage values are >=
# FULL_COVER; torch compares an f32 tensor against the scalar rounded to
# f32, FULL_COVER_F32 (1 - 17 * 2**-24), which the kernel takes
FULL_COVER = 1.0 - 1e-6
FULL_COVER_F32 = float(np.float32(FULL_COVER))


def occlusion_los(cov, opaque, starts_g):
    """Each tile's composite-walk start: the LAST fragment of [starts_g[t],
    starts_g[t + 1]) that is ``opaque`` and fully covers the tile (see
    ``occlusion_los_plain``), else starts_g[t]. cov (F, 256) f32 coverage
    rows, opaque (F,) bool, starts_g (G + 1,) i32 nondecreasing -> los
    (G,) i32. On the card one launch, which reads only opaque rows of the
    tiles' ranges, from the top down to the window of the last full one."""
    if _on_cpu(cov, opaque, starts_g):
        return occlusion_los_plain(cov, opaque, starts_g)
    if starts_g.dim() != 1 or starts_g.shape[0] < 1:
        raise ValueError(f"starts_g: shape {tuple(starts_g.shape)}, "
                         f"expected (G + 1,)")
    f = cov.shape[0]
    g = starts_g.shape[0] - 1
    _check(cov, "cov", torch.float32, (f, NPX))
    _check(opaque, "opaque", torch.bool, (f,))
    _check(starts_g, "starts_g", torch.int32, (g + 1,))
    if cov.data_ptr() % 16:
        raise ValueError("cov must start on a 16-byte boundary")
    los = torch.empty(g, dtype=torch.int32, device=cov.device)
    if g:
        _launch("occlusion_los", _load().vt_occlusion_los, cov, opaque,
                starts_g, g, FULL_COVER_F32, los)
    return los


def occlusion_los_plain(cov, opaque, starts_g):
    """Plain version of the occlusion walk's starts: a running max of the
    index of each opaque fragment whose least coverage value is >=
    FULL_COVER (a NaN is not), read at each tile's last fragment and
    clamped into the tile (a max reaching back into an earlier tile
    clamps to the tile's start; an empty tile starts at its start)."""
    lo0, hi0 = starts_g[:-1], starts_g[1:]
    if cov.shape[0] == 0:
        return lo0.clone()
    full = torch.amin(cov, dim=1) >= FULL_COVER
    idx = torch.arange(cov.shape[0], dtype=torch.int32, device=cov.device)
    m = torch.cummax(torch.where(opaque & full, idx, -1), 0).values
    cover = m[(hi0 - 1).clamp_min(0).long()]
    return torch.where(hi0 > lo0,
                       torch.minimum(torch.maximum(cover, lo0), hi0), lo0)
