"""Device ms per frame under stages s01-s05: tile allocation, flatten
(K1), touch expansion (K2), the coarse sort and segment starts."""

from ._stages import stage_ms


def read(run):
    return stage_ms(run, ("s01", "s02", "s03", "s04", "s05"))
