"""Host ms of the port's ``vt.upload`` span (``pack_buffers`` and
``to_torch`` of a resolved scene in ``Renderer``), in set-up; the mean
over the uploads recorded. None in a run with no device trace (the
CPU's), where the program has no recorder, or where it holds nothing."""

from .frame_host_ms import recorder


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.span_ms("vt.upload")
