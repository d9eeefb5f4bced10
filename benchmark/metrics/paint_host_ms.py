"""Host self ms per frame of the port's stage s09 (``eval_paints``), the
mean over the frames the program recorded. None in a run with no device
trace (the CPU's), where the program has no recorder, or where it holds
nothing."""

from .frame_host_ms import recorder

PREFIXES = ("s09_",)


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.stage_host_ms(PREFIXES)
