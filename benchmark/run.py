#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up builds the cell's scenes from the seed through the port's Scene
API, resolves them, and warms every frame the window will draw; then the
window runs the cell's traffic loop for ``--seconds``; then the frames it
kept are held to the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics
read from a profiler trace of a block of frames in the middle of the
window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit (also the last lines of
standard error).

Without a CUDA device, or with fewer than the cell asks for, it exits 3
and prints no result. It exits 4 and prints no result if JAX, jaxlib,
flax or the JAX package ``vello_tpu`` has been loaded. ``--control
speed`` renders the timed path in the port's render_mode "speed" and
``--control bf16`` puts the reference, its composite folded in bfloat16,
in its place:
the controls that the output check has to fail (not part of a cell's
runs)."""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "vello_tpu")


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc, in
    clock ticks since boot), or since this module was first run where
    /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        start = int(stat[stat.rindex(")") + 2:].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def foreign_modules() -> list:
    """Loaded modules whose whole top-level name is a JAX one or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("speed", "bf16"), default=None)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    """Run a cell; ``device`` "cpu" and ``overrides`` ({"config": {...},
    "traffic": {...}}, merged into the cell's files) are for the tests,
    which run a cell at a tiny size with the kernels' plain versions."""
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark import cells
    cell = cells.load(args.workload)
    import torch
    if device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA "
                  f"device(s), found {n}", file=sys.stderr)
            return 3
    from benchmark import harness
    result = harness.run(cell, args, device, overrides or {},
                         age=process_age_s, foreign=foreign_modules)
    found = foreign_modules()
    if result is None or found:
        print(f"benchmark: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
