"""A configuration, a traffic mix and a per-layer metric are added as
new files and manifest entries, in a copy of the benchmark, and a cell of
them runs with no file that was there edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

_RUN = """
import json, sys
import torch
torch.set_num_threads(2)
sys.path.insert(0, ".")
from benchmark import run
rc = run.main(["--workload", "mmark_two.soup_one", "--seed", "9",
               "--seconds", "1", "--trace", "1"], device="cpu")
sys.exit(rc)
"""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".pyc"):
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_add_config_mix_and_metric(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    os.symlink(os.path.join(ROOT, "vello_tpu_torch"),
               tmp_path / "vello_tpu_torch")
    before = _digests(tmp_path / "benchmark")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    conf = json.loads((tmp_path / "benchmark/configs/mmark.json")
                      .read_text())
    conf.update(elements=800, width=96, height=54)
    (tmp_path / "benchmark/configs/mmark_two.json").write_text(
        json.dumps(conf))
    (tmp_path / "benchmark/traffic/soup_one.json").write_text(json.dumps(
        {"scene": "mmark_rs", "loop": "resident", "in_flight": 1}))
    (tmp_path / "benchmark/limits/mmark_two.soup_one.json").write_text(
        json.dumps({"diff_share": 0.002, "overflow_frames": 0}))
    (tmp_path / "benchmark/metrics/frames_traced.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else run.trace.frames\n")
    bench["configs"].append({"name": "mmark_two", "source": "x",
                             "file": "benchmark/configs/mmark_two.json",
                             "reduced": ["elements"], "why": "test"})
    bench["workloads"].append({"name": "mmark_two.soup_one",
                               "config": "mmark_two",
                               "traffic": "soup_one", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "the device", "moves": "frame_ms",
                               "workloads": ["mmark_two.soup_one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    p = subprocess.run([sys.executable, "-c", _RUN], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["frames_traced"]["value"] >= 5
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
