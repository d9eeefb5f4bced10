"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.
Cells run at a tiny size with the kernels' plain versions on the CPU; a
test marked ``cuda`` needs the card and skips without one."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each cell's configuration at a size a CPU test run holds
TINY = {"mmark": {"elements": 1500, "width": 128, "height": 72}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cell(cell, seed=2147483651, seconds=1.0, trace=0, control=None,
             capsys=None):
    """Run a cell on the CPU at its tiny size; (exit code, result dict
    parsed from the last line of standard output, standard error)."""
    import json
    from benchmark import run
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if control:
        argv += ["--control", control]
    rc = run.main(argv, device="cpu",
                  overrides={"config": TINY[cell.split(".")[0]]})
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
