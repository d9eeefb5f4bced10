"""A cell of ``BENCHMARK.json`` and the files it is made of, found by
name."""

from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # this cell's end-to-end metric entries
    per_layer: list           # this cell's per-layer metric entries

    def scene_module(self):
        return importlib.import_module(
            f"benchmark.scenes.{self.traffic['scene']}")


def load(workload: str, manifest: str = MANIFEST) -> Cell:
    """The cell ``workload`` with its configuration, traffic mix, limits
    and metrics; raises KeyError for a cell the manifest does not hold."""
    bench = _json(manifest)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest}")
    w = cells[workload]
    base = os.path.dirname(os.path.abspath(manifest))
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(m):
        return workload in m.get("workloads", (workload,))
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    # a per-layer metric without "workloads" is read in every cell that
    # reports the end-to-end metric it moves
    per = [m for m in bench["per_layer"]
           if mine(m) and ("workloads" in m or m["moves"] in names)]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(base, conf["file"])),
        traffic=_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(HERE, "limits", f"{workload}.json")),
        end_to_end=e2e, per_layer=per)


def reader(metric: str):
    """The ``read(run)`` function of a per-layer metric's reader."""
    return importlib.import_module(f"benchmark.metrics.{metric}").read
