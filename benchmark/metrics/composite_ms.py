"""Device ms per frame under stages s09b, s10 and s19-s21: the occlusion
walk's cummax, the flat composite (K4 or K6) with the image assembly,
and the layered frame's rank bounds, draws ops (K7) and pushes."""

from ._stages import stage_ms


def read(run):
    return stage_ms(run, ("s09b", "s10", "s19", "s20", "s21"))
