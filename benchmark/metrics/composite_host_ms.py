"""Host self ms per frame of the port's stages s09b, s10 and s19-s21 (the
occlusion walk's cummax, the flat composite with the image assembly, the
layered frame's rank bounds, draws ops and pushes), the mean over the
frames the program recorded. None in a run with no device trace (the
CPU's), where the program has no recorder, or where it holds nothing."""

from .frame_host_ms import recorder

PREFIXES = ("s09b", "s10", "s19", "s20", "s21")


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.stage_host_ms(PREFIXES)
