"""Host ms of the port's frame call per frame: its ``vt.frame`` span,
opened by the frame that ``Renderer.frame_thunk()`` hands out, the mean
over the frames the program recorded (the traced block's, while the
profiler records). None in a run with no device trace (the CPU's), where
the program has no recorder, or where it holds nothing."""


def recorder(run):
    """The port's ``RECORDER`` in a run on the card (one with a device
    trace), or None: on the CPU the host spans time the kernels' plain
    versions, not the program's frame, and an older program has no
    recorder."""
    if run.trace is None or not run.trace.busy_ns:
        return None
    from vello_tpu_torch.utils import profile
    return getattr(profile, "RECORDER", None)


def read(run):
    rec = recorder(run)
    return None if rec is None else rec.frame_host_ms()
