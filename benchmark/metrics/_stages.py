"""Device ms per frame under a group of the program's stage ranges."""


def stage_ms(run, prefixes):
    """0 where the cell runs none of these stages; None without a device
    trace."""
    tr = run.trace
    if tr is None or tr.busy_ns == 0:
        return None
    return tr.stage_ms(prefixes)
