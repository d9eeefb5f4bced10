"""Device ms per frame under stages s06-s08: area coverage (K5), the
live cull and sort, msaa coverage (K3)."""

from ._stages import stage_ms


def read(run):
    return stage_ms(run, ("s06", "s07", "s08"))
