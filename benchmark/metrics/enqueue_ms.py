"""Host ms of a frame call, the mean over the window's frames (host
clock): the renderer's and the pipeline's host side. A resident frame's
call never waits."""


def read(run):
    s = run.enqueue_s
    return 1e3 * sum(s) / len(s) if s else None
