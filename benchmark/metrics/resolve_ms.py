"""Host ms of the port's ``resolve`` of one of the cell's scenes, in
set-up (the benchmark's ``bench.resolve`` span)."""


def read(run):
    s = run.spans.get("bench.resolve")
    return 1e3 * sum(s) / len(s) if s else None
