"""Each cell at a tiny size on the CPU, with the kernels' plain versions:
a run prints one result line with the contract's keys, its output check
passes, and a traced run reports the cell's per-layer metrics."""

import json
import os

import pytest
import torch

from benchmark.tests.conftest import ROOT, run_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_its_result_line(cell, capsys):
    rc, res, err = run_cell(cell, capsys=capsys)
    assert rc == 0
    assert list(res) == RESULT_KEYS           # "checks" comes last
    assert res["correct"] is True and res["attempted"] > 0
    assert res["failed"] == 0
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert set(res["metrics"]) == e2e
    assert all(v["value"] > 0 for k, v in res["metrics"].items()
               if k != "peak_gb")             # no device memory on the CPU
    assert res["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line == f"check {name}: {c['value']} (limit {c['limit']})"


def test_traced_run_reports_per_layer_metrics(capsys):
    rc, res, _ = run_cell(CELLS[0], trace=1, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    # the CPU has no device trace: the readers of device time find
    # nothing and are left out
    assert set(res["metrics"]) == {"encode_ms", "resolve_ms", "enqueue_ms"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_no_card_no_result(capsys, monkeypatch):
    """On the card's path a run without CUDA exits non-zero, printing no
    result line."""
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err


@pytest.mark.cuda
def test_cell_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "2147483700", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
