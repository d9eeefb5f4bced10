"""A run loads no JAX and not the JAX package; the reference loads
nothing of the port. Modules are told apart by their whole top-level
name: ``vello_tpu_torch`` begins with ``vello_tpu``."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

_RUN = """
import json, sys
import torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.tests.conftest import TINY
rc = run.main(["--workload", "mmark.resident", "--seed", "5", "--seconds",
               "1", "--trace", "0"], device="cpu",
              overrides={"config": TINY["mmark"]})
print(json.dumps({"rc": rc, "tops": sorted({m.split(".")[0]
                                            for m in sys.modules})}))
"""

_REFERENCE = """
import json, sys, types
import torch
torch.set_num_threads(2)
from benchmark import compare
from benchmark.scenes import mmark_rs
from benchmark.tests.conftest import TINY
cfg = dict(json.load(open("benchmark/configs/mmark.json")), **TINY["mmark"])
frames = compare.reference_frames(mmark_rs, cfg, [{}], 5, "cpu")
print(json.dumps({"shape": list(frames[0].shape),
                  "tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "mods": sorted(m for m in sys.modules
                                 if m.startswith("benchmark"))}))
"""


def _last_json(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    got = _last_json(_RUN)
    assert got["rc"] == 0
    assert not {"jax", "jaxlib", "flax", "vello_tpu"} & set(got["tops"])
    assert "vello_tpu_torch" in got["tops"]


def test_the_reference_loads_nothing_of_the_port():
    got = _last_json(_REFERENCE)
    assert got["shape"] == [72, 128, 4]
    assert not {"vello_tpu_torch", "vello_tpu", "jax", "jaxlib"} \
        & set(got["tops"])
    assert "benchmark.reference" in got["mods"]
