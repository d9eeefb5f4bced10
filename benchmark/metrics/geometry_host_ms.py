"""Host self ms per frame of the port's stages s01-s05 (tile allocation,
flatten (K1), touch expansion (K2), the coarse sort and segment starts),
the mean over the frames the program recorded. None in a run with no
device trace (the CPU's), where the program has no recorder, or where it
holds nothing."""

from .frame_host_ms import recorder

PREFIXES = ("s01", "s02", "s03", "s04", "s05")


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.stage_host_ms(PREFIXES)
