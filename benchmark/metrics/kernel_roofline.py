"""The port's kernels' share of their roofline in a frame, %: the sum of
the bounds of one frame's launches (``roofline.bound`` on their own
inputs, against the published H100 peaks) over their profiled device
time per frame: for each kernel, its launches in the frame times the
mean time per traced event of each device kernel it runs (a trace can
lose events)."""

from ..roofline import kernel_of


def read(run):
    tr, bounds = run.trace, run.bounds
    if tr is None or not bounds:
        return None
    per_launch = {}
    for name, (ns, n) in tr.by_name().items():
        k = kernel_of(name)
        if k in bounds and n:
            per_launch[k] = per_launch.get(k, 0.0) + ns / n / 1e6
    prof_ms = sum(bounds[k][0] * ms for k, ms in per_launch.items())
    if prof_ms <= 0:
        return None
    return 100.0 * sum(bounds[k][1] for k in per_launch) / prof_ms
