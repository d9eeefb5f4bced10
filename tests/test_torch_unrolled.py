"""The port's unrolled layered formulation (``VELLO_TPU_UNROLLED_LAYERS=1``)
against the JAX package's, on the CPU: 128x128 frames of the clip scene
and of blend_grid in msaa16, u8 within 1 level with at least 99% of the
bytes identical, the port's K8 once per clipped push. Most of the time
here is the JAX package's compile of its unrolled frames, so these tests
sit in a file of their own, which pytest-xdist runs beside
test_torch_layers_*.py.
"""

import pytest

from test_torch_layers_frames import check_frame
from test_torch_layers_plan import jax_interpret  # noqa: F401  (a fixture)
from test_torch_layers_unrolled import spy_segment_sums
from test_torch_pipeline import one_torch_thread  # noqa: F401 (autouse)
from vello_tpu_torch.pipeline import layered


@pytest.mark.parametrize("name", ["clips", "blend_grid"])
def test_unrolled_frame_matches_jax(jax_interpret, monkeypatch, name):
    """Both packages on their unrolled formulation: the port's K8 runs once
    per clipped push. (At 128x128 the JAX side has fewer than 4096 rows, so
    its ``_cumsum0`` takes ``jnp.cumsum``; test_torch_segmented.py holds
    K8's plain version to the Pallas kernel.)"""
    monkeypatch.setenv("VELLO_TPU_UNROLLED_LAYERS", "1")
    sums = spy_segment_sums(monkeypatch)
    plan = check_frame(monkeypatch, name, "msaa16")
    n = layered.clipped_pushes(plan)
    assert n > 0 and sums == {"segment_sum_sorted": n, "cumsum0": n}
