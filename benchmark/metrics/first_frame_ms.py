"""Host ms of the port's ``vt.first_frame`` span (a resolved scene's first
frame on its new buffers, up to its overflow read, the kernel library's
load included), in set-up; the mean over those recorded. None in a run
with no device trace (the CPU's), where the program has no recorder, or
where it holds nothing."""

from .frame_host_ms import recorder


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.span_ms("vt.first_frame")
