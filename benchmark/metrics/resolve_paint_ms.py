"""Host ms of the port's ``vt.resolve.paint`` span (paints, fill rules,
draws and layers of ``resolve``), in set-up; the mean over the resolves
recorded. None in a run with no device trace (the CPU's), where the
program has no recorder, or where it holds nothing."""

from .frame_host_ms import recorder


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.span_ms("vt.resolve.paint")
