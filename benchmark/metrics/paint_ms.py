"""Device ms per frame under stage s09 (``ops/fine.eval_paints``)."""

from ._stages import stage_ms


def read(run):
    return stage_ms(run, ("s09_",))
