"""The share of a frame's wall time in which the device ran nothing, %:
1 - the device's busy ms per frame in the traced block (kernels, copies
and fills; overlaps counted once; the block follows the window) / the
window's wall ms per frame. The profiler slows the host's side of a
frame, so the traced block's own window would overstate the idle share
of a frame the host paces."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_ns == 0 or not run.frame_ms:
        return None
    return 100.0 * (1.0 - tr.busy_ns / 1e6 / tr.frames / run.frame_ms)
