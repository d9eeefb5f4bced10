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

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
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
from vello_tpu_torch.parallel import launch, mesh
from vello_tpu_torch.tools import dryrun_multichip, mesh_throughput
assert callable(mesh.make_mesh) and callable(mesh.build_sharded_renderer)
assert callable(mesh.render_batch) and isinstance(mesh.MeshRenderer, type)
assert callable(launch.run_ranks) and callable(dryrun_multichip.run_checks)
assert callable(mesh_throughput.main)
from vello_tpu_torch.examples import animation, demo, headless
from vello_tpu_torch import bench
from vello_tpu_torch.tools import make_gallery
assert all(callable(m.main) for m in (animation, demo, headless,
                                      make_gallery, bench))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "vello_tpu"))
print("MODULES", len(names), "FOREIGN", len(loaded), loaded[:5])
"""


# the host modules copied for text, the oracle, the corpus, SVG, the probe
# and debug
HOST_MODULES = ("vello_tpu_torch.text", "vello_tpu_torch.colr",
                "vello_tpu_torch.oracle.renderer",
                "vello_tpu_torch.oracle.np_blend",
                "vello_tpu_torch.oracle.np_paint",
                "vello_tpu_torch.oracle.np_blur",
                "vello_tpu_torch.oracle.np_filters",
                "vello_tpu_torch.scenes.reference_scenes",
                "vello_tpu_torch.utils.svg", "vello_tpu_torch.utils.rust_rand",
                "vello_tpu_torch.utils.probe", "vello_tpu_torch.utils.debug")

# the font libraries refused at import, as on a host without them: every
# module still imports, and the oracle, the corpus, SVG, the probe and
# text run
_NO_FONT_LIBS = """
import importlib
import importlib.abc
import pkgutil
import sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("fontTools", "PIL", "matplotlib"):
            raise ImportError(f"no {name} here")
        return None

sys.meta_path.insert(0, Refuse())
import vello_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vello_tpu_torch.__path__,
                                               "vello_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from vello_tpu_torch.oracle import OracleRenderer
from vello_tpu_torch.scenes.reference_scenes import build_for_golden
from vello_tpu_torch.utils import probe, svg
scene, _ = build_for_golden("many_clips", 32, 32)
img = OracleRenderer().render(scene, vello_tpu_torch.RenderParams(32, 32))
assert img.shape == (32, 32, 4) and img[..., 3].max() > 0
assert probe.run_probe(vello_tpu_torch.Renderer(device="cpu"))
svg.load_svg('<svg><path d="M1 1 L9 1 L5 8 Z"/></svg>')
# text reads its font itself; hinting still needs PIL
from vello_tpu_torch.text import default_font, layout_text
s = vello_tpu_torch.Scene()
s.draw_text("x", 0, 10, 10, vello_tpu_torch.palette.WHITE)
assert vello_tpu_torch.resolve(
    s.encoding, vello_tpu_torch.RenderParams(16, 16)).n_segs > 0
try:
    (s.draw_glyphs(default_font()).font_size(10.0).hint(True)
     .draw(vello_tpu_torch.Fill.NON_ZERO,
           layout_text(default_font(), 10.0, "x", (0.0, 10.0))))
except ImportError:
    pass
else:
    raise AssertionError("hinting ran without PIL")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "vello_tpu", "fontTools", "PIL",
                 "matplotlib"))
print("MODULES", len(names), "FOREIGN", len(loaded), loaded[:5])
print("NAMES", " ".join(names))
"""


def test_host_modules_import_without_font_libraries():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _NO_FONT_LIBS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN 0 []" in out.stdout, out.stdout
    names = set(out.stdout.split("NAMES")[1].split())
    assert set(HOST_MODULES) <= names, set(HOST_MODULES) - names


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



_ONE_THREAD = re.compile(
    r"^(from test_torch_pipeline import one_torch_thread\b|"
    r"def one_torch_thread\()", re.M)


def test_cpu_test_modules_run_torch_in_one_thread():
    """Every CPU test module of the port takes the autouse fixture
    ``one_torch_thread`` (defined in test_torch_pipeline.py, imported by
    the others): a module without it runs torch's pool threads against the
    other pytest-xdist workers. test_torch_cuda.py runs on the card."""
    tests = os.path.join(REPO, "tests")
    names = sorted(f for f in os.listdir(tests)
                   if re.fullmatch(r"test_torch_.*\.py", f)
                   and f != "test_torch_cuda.py")
    assert len(names) > 20
    missing = []
    for name in names:
        with open(os.path.join(tests, name)) as f:
            if not _ONE_THREAD.search(f.read()):
                missing.append(name)
    assert not missing, missing
    assert torch.get_num_threads() == 1

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
    raw = kernels.coverage_area_raw(*args[:2])
    assert torch.equal(raw, fine.coverage_area_raw_plain(*args[:2]))

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
