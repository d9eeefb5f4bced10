"""The port's reference scene corpus (``scenes/reference_scenes.py``, a copy
of the JAX package's) on the CPU, one case per scene.

Each scene is built through each package at its golden size
(``test_reference_goldens.SIZES``) and resolved; every field of the two
``ResolvedScene``s must be equal (``test_torch_host._assert_same``). The
port's ``Renderer(device="cpu")`` frame of the resolved scene is then held
to the bars of ``test_reference_goldens.test_ported_scene_device_vs_oracle``,
the bars ``chip_smoke.py`` phase 6 holds the GPU frame to: mean abs within
2.5e-3 of the port's oracle (not on many_draw_objects: its 90k paths take
the oracle minutes) and, against ``tests/snapshots/ref_<name>.png``, RGBA8
mean < 0.002 and max < 4.01/255 (``tests/snapshot.py``). The cases are
phase 6's scenes (``chip_smoke.corpus_names``): all but the three that
draw text in Roboto, a font the repository does not hold.
"""

import importlib
import os
import sys

import numpy as np
import pytest

import vello_tpu
import vello_tpu_torch
from test_reference_goldens import SIZES
from test_torch_host import _assert_same
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch import Renderer
from vello_tpu_torch.oracle import OracleRenderer
from vello_tpu_torch.scenes.reference_scenes import REFERENCE_SCENES, _ROBOTO

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _build_and_resolve(pkg, name):
    refs = importlib.import_module(f"{pkg.__name__}.scenes.reference_scenes")
    res = importlib.import_module(f"{pkg.__name__}.encoding.resolve")
    w, h = SIZES[name]
    scene, base = refs.build_for_golden(name, w, h)
    bc = ((base.r, base.g, base.b, base.a) if base is not None
          else (0.0, 0.0, 0.0, 1.0))
    params = pkg.RenderParams(w, h, base_color=bc)
    return res.resolve(scene.encoding, params), params


def test_corpus_is_the_jax_package_corpus():
    from vello_tpu.scenes import reference_scenes as jax_refs
    assert list(REFERENCE_SCENES) == list(jax_refs.REFERENCE_SCENES)
    assert set(REFERENCE_SCENES) == set(SIZES)
    assert os.path.basename(_ROBOTO) == os.path.basename(jax_refs._ROBOTO)
    # the port looks Roboto up inside the repository only
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _ROBOTO.startswith(os.path.join(repo, "assets") + os.sep)


@pytest.mark.parametrize("name", chip_smoke.corpus_names())
def test_reference_scene_resolves_equal_and_meets_its_bars(name):
    ours, params = _build_and_resolve(vello_tpu_torch, name)
    ref, jparams = _build_and_resolve(vello_tpu, name)
    assert type(ours).__module__ == "vello_tpu_torch.encoding.resolve"
    _assert_same(ours, ref, "ResolvedScene")
    assert ours.capacities(params).key() == ref.capacities(jparams).key()

    r = Renderer(device="cpu")
    img = r.render_resolved(ours, params)
    assert r.last_profile["retries"] == 0
    assert img.shape == (params.height, params.width, 4)
    if name not in chip_smoke.GOLDEN_ONLY:
        orc = OracleRenderer().render_resolved(ours, params)
        assert np.abs(img - orc).mean() < chip_smoke.ORACLE_MEAN_TOL, name
    gmean, gmax = chip_smoke.golden_diff(name, img)
    assert gmean < chip_smoke.GOLDEN_MEAN_TOL, (name, gmean)
    assert gmax < chip_smoke.GOLDEN_MAX_TOL, (name, gmax * 255)
