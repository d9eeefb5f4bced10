"""vello_tpu_torch imports neither JAX nor the JAX package, and its kernel
wrappers route CPU tensors to their plain PyTorch versions without
launching anything."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vello_tpu_torch.ops import fine, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib
import pkgutil
import sys
import vello_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vello_tpu_torch.__path__,
                                               "vello_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from vello_tpu_torch.scenes.test_scenes import filled_mmark
filled_mmark(1, 64.0)
from vello_tpu_torch.ops import blend, blur, filters, paint
from vello_tpu_torch.pipeline import layered
assert callable(blur.blurred_rounded_rect_coverage)
assert callable(paint.radial_t)
assert callable(blend.blend_mix_compose_dyn)
assert callable(filters.apply_filter_dyn)
assert callable(layered.render_frame_layered)
assert callable(layered.render_frame_layered_scan)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "vello_tpu"))
print("MODULES", len(names), "FOREIGN", len(loaded), loaded[:5])
"""


def test_package_imports_no_jax_and_no_vello_tpu():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN 0 []" in out.stdout, out.stdout
    n_modules = int(out.stdout.split()[1])
    assert n_modules >= 20, out.stdout     # the host copy and the device side


_FOREIGN_IMPORT = re.compile(
    r"^\s*(from\s+vello_tpu(\.\S+)?\s+import|import\s+vello_tpu(\.|\s|$))",
    re.M)


def test_sources_do_not_import_vello_tpu():
    """No source of the port, and not chip_smoke.py, names the JAX package
    in an import statement (``vello_tpu_torch`` itself is fine)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vello_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    offenders = []
    for path in paths:
        with open(path) as f:
            for m in _FOREIGN_IMPORT.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, REPO)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders
    assert _FOREIGN_IMPORT.search("from vello_tpu.kurbo import Affine")
    assert _FOREIGN_IMPORT.search("    import vello_tpu")
    assert not _FOREIGN_IMPORT.search("from vello_tpu_torch import Scene")
    assert not _FOREIGN_IMPORT.search("import vello_tpu_torch.ops")


def _stream(rng, t=64, f=12):
    fid = np.sort(rng.integers(0, f, t))
    seg = rng.uniform(0, 16, (t, 4)).astype(np.float32)
    trow = np.zeros((t, 8), np.float32)
    trow[:, :4] = seg
    trow[:, 4] = 1e9
    starts = np.searchsorted(fid, np.arange(f + 1)).astype(np.int32)
    return trow, starts


def test_cpu_tensors_take_plain_versions():
    kernels.reset_launches()
    rng = np.random.default_rng(5)
    trow, starts = _stream(rng)
    f = starts.shape[0] - 1
    args = (torch.from_numpy(trow), torch.from_numpy(starts),
            torch.arange(f, dtype=torch.int32), torch.zeros(f),
            torch.zeros(f, dtype=torch.int32), torch.ones(f, dtype=torch.bool))
    cov = kernels.msaa_coverage(*args, ns=16)
    assert torch.equal(cov, fine.msaa_coverage_plain(*args, ns=16))

    col = torch.rand(f, 4)
    los = torch.from_numpy(starts[:-1].copy())
    his = torch.from_numpy(starts[1:].copy())
    base = torch.tensor([0.1, 0.1, 0.1, 1.0])
    out = kernels.composite_solid(cov, col, base, los, his)
    assert torch.equal(out, fine.composite_solid_plain(cov, col, base, los,
                                                       his))

    spack = torch.zeros(4, 16)
    spack[:, 8] = 1.0
    incl = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    lp = kernels.flatten_lines(spack, incl, 1024, 64.0, 64.0)
    assert lp.shape == (16, 1024)
    pay = kernels.expand_touches(lp, torch.ones(1024, dtype=torch.int32)
                                 .cumsum(0, dtype=torch.int32), 2048)
    assert pay.shape == (8, 2048)

    area_args = args[:2] + args[3:]
    for centers in (False, True):
        cov = kernels.coverage_area(*area_args, centers)
        assert torch.equal(cov, fine.coverage_area_plain(*area_args,
                                                         centers))

    src = col[:, :, None] * cov[:, None, :]
    out = kernels.composite_src(src, base, los, his)
    assert torch.equal(out, fine.composite_src_plain(src, base, los, his))

    # K1 with the stroke columns [hw, jnx, jny, m, join]: one mini of 7
    sspack = torch.zeros(1, 21)
    sspack[0, 0:8] = torch.tensor([0., 0., 10., 0., 20., 0., 30., 0.])
    sspack[0, 8] = 7.0
    sspack[0, 12] = sspack[0, 14] = 4.0      # rect tx1, stride: live
    sspack[0, 16] = 2.0
    sspack[0, 19] = 1.0
    slp = kernels.flatten_lines(sspack, torch.tensor([7], dtype=torch.int32),
                                1024, 64.0, 64.0)
    assert slp.shape == (16, 1024)
    assert slp[6, :7].sum() > 0 and slp[6, 7:].sum() == 0    # live rows
    # K7 updates its buffer in place: tile 0 takes its walk, the tiles with
    # an empty walk keep their values
    buf = torch.rand(f, 4, 256)
    before = buf.clone()
    his_one = los.clone()
    his_one[0] = his[0]
    assert his_one[0] > los[0]
    out = kernels.composite_over(src, buf, los, his_one)
    assert out is buf and torch.equal(buf[1:], before[1:])
    assert not torch.equal(buf[0], before[0])
    assert all(v == 0 for v in kernels.launches.values()), kernels.launches


def test_mixed_devices_rejected():
    with pytest.raises(ValueError):
        kernels._on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))


def test_cuda_renderer_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    from vello_tpu_torch import Renderer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(device="cuda")
