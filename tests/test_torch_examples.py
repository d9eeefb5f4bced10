"""The repository's entry-point scripts on the port
(``vello_tpu_torch/examples/{headless,animation,demo}.py``,
``vello_tpu_torch/tools/make_gallery.py``), run on the CPU with ``--cpu``.

``headless`` runs as a subprocess beside the JAX package's
``examples/headless.py --cpu`` on the same scene; the two PNGs agree
within one level per channel. The others run in-process at small sizes
and write where they are told (``make_gallery`` under its OUT_DIR
argument, ``animation`` and ``demo`` into the temporary directory)."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_headless_matches_jax_headless(tmp_path):
    port, ref = tmp_path / "port.png", tmp_path / "jax.png"
    said = _run(["-m", "vello_tpu_torch.examples.headless", "splash",
                 str(port), "--size", "96", "--cpu"], tmp_path)
    assert "(device)" in said and str(port) in said
    _run([os.path.join("examples", "headless.py"), "splash", str(ref),
          "--size", "96", "--cpu"], tmp_path)
    got, want = read_png(str(port)), read_png(str(ref))
    assert got.shape == want.shape == (96, 96, 4)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 8


def test_headless_lists_its_scenes(capsys):
    from vello_tpu_torch.examples import headless
    headless.main(["--list"])
    names = capsys.readouterr().out.split(":", 1)[1].replace(",", " ")
    assert {"splash", "tiger", "filled_mmark", "blend_grid"} <= set(
        names.split())


def test_make_gallery_writes_under_its_directory(tmp_path, capsys):
    from vello_tpu_torch.tools import make_gallery
    out = tmp_path / "gallery"
    make_gallery.main([str(out), "splash", "--cpu"])
    assert sorted(os.listdir(out)) == ["splash.png"]
    img = read_png(str(out / "splash.png"))
    assert img.shape == (512, 512, 4) and img[..., 3].min() == 255
    assert "wrote" in capsys.readouterr().out


@pytest.mark.parametrize("script", ["animation", "demo"])
def test_frame_loops_run(monkeypatch, tmp_path, capsys, script):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    if script == "animation":
        from vello_tpu_torch.examples import animation
        animation.main(["2", "48", "--cpu"])
        name = "animation_last.png"
    else:
        pytest.importorskip("fontTools")
        from vello_tpu_torch.examples import demo
        demo.main(["--frames", "2", "--size", "96", "--aa", "msaa16",
                   "--cpu"])
        name = "demo_last.png"
    img = read_png(str(tmp_path / name))
    assert img[..., 3].min() == 255 and len(np.unique(img[..., 0])) > 4
    assert str(tmp_path / name) in capsys.readouterr().out
