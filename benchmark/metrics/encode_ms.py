"""Host ms to build one of the cell's scenes through the port's Scene
API, in set-up (the benchmark's ``bench.encode`` span)."""


def read(run):
    s = run.spans.get("bench.encode")
    return 1e3 * sum(s) / len(s) if s else None
