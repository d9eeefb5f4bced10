"""The general traffic driver: the loops a traffic mix names.

- ``resident``: one scene, resolved and uploaded in set-up, redrawn
  through the port's ``Renderer.frame_thunk()`` with at most
  ``in_flight`` frames in flight (the caller waits for the oldest one's
  completion before it enqueues another).

A frame completes at a CUDA event recorded after its launches. A loop
keeps a few frames for the output check: frames at indices drawn from the
seed and the last frame, copied to the host."""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

WARM_FRAMES = 3
TRACE_S = 0.5             # a traced block's length, about
TRACE_MAX = 150           # and its most frames
TRACE_WARM = 2            # its first frames, traced and dropped


def span(name: str):
    """A benchmark host span: a profiler range while one records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Marks:
    """Completion marks: CUDA events on the card, the host clock on the
    CPU (where a frame is complete when its call returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def gaps_ms(self, start, marks) -> list:
        """ms from each mark to the next, the first from ``start``."""
        prev, out = start, []
        for m in marks:
            out.append(prev.elapsed_time(m) if self.cuda
                       else (m - prev) * 1e3)
            prev = m
        return out


class Window:
    """What one measured window gave."""

    def __init__(self):
        self.frames = 0
        self.wall_s = 0.0
        self.gaps_ms = []
        self.kept = []            # (scene index, HxWx4 uint8 numpy)
        self.overflow_frames = 0
        self.peak_bytes = 0
        self.enqueue_s = []       # host seconds of the frame calls
        self.trace = None         # the traced block after the window
        self.traced_frames = 0


def _keep_at(seed: int, n_keep: int, est_frames: int) -> set:
    """Frame indices drawn from the seed, within the frames the window
    is expected to complete."""
    gen = np.random.default_rng([int(seed) % 2 ** 64, 7])
    hi = max(int(est_frames * 0.9), 1)
    return set(gen.choice(hi, size=min(n_keep, hi), replace=False).tolist())


class Loop:
    frame_span = "bench.frame"

    def __init__(self, renderer, scenes, params, traffic, device, seed):
        self.r = renderer
        self.scenes = scenes          # [(scene args, resolved scene)]
        self.params = params
        self.traffic = traffic
        self.device = torch.device(device)
        self.seed = seed
        self.marks = Marks(self.device)
        self.frame_s = None

    # each loop: warm(), frame(i, win) -> completion mark, finish(win)

    def run(self, seconds: float, trace: bool) -> Window:
        """The measured window; with ``trace`` a traced block of frames
        follows it (a profiler leaves the host slower after it has run,
        so no measured frame comes after one)."""
        win = Window()
        keep = _keep_at(self.seed, int(self.traffic.get("kept_frames", 4)),
                        int(seconds / self.frame_s))
        marks = []
        cuda = self.device.type == "cuda"
        if cuda:
            self.marks.sync()
            torch.cuda.reset_peak_memory_stats()
        start = self.marks.mark()
        t0 = time.perf_counter()
        i = 0
        while True:
            marks.append(self.frame(i, win, i in keep, timed=True))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.marks.sync()
        win.wall_s = time.perf_counter() - t0
        win.frames = i
        if cuda:
            win.peak_bytes = torch.cuda.max_memory_allocated()
        win.gaps_ms = self.marks.gaps_ms(start, marks)
        if trace:
            self._traced_block(i, win)
        self.finish(win)
        return win

    def _traced_block(self, i, win) -> None:
        """A traced block of frames after the window: the host's ops and
        the device's operations, with the stage each kernel ran under.
        The profiler slows the host's side of each frame, so the window's
        frames give the frame time that the idle share is taken
        against."""
        from torch.profiler import ProfilerActivity, profile, schedule
        from . import trace as trace_mod
        active = int(min(max(TRACE_S / self.frame_s, 5), TRACE_MAX))
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=TRACE_WARM, active=active,
                repeat=1)) as prof:
            for k in range(TRACE_WARM + active):
                self.frame(i, win, False, timed=False)
                i += 1
                if k in (TRACE_WARM - 1, TRACE_WARM + active - 1):
                    self.marks.sync()
                prof.step()
        win.traced_frames = TRACE_WARM + active
        win.trace = trace_mod.read(prof.profiler.kineto_results.events(),
                                   active)

    def _time_warm(self, frame) -> None:
        self.marks.sync()
        t = time.perf_counter()
        for _ in range(WARM_FRAMES):
            frame()
        self.marks.sync()
        self.frame_s = max((time.perf_counter() - t) / WARM_FRAMES, 1e-4)


class Resident(Loop):
    frame_span = "bench.enqueue"

    def warm(self) -> None:
        rs = self.scenes[0][1]
        self.r.render_resolved(rs, self.params, out="rgba8")
        self.thunk = self.r.frame_thunk()
        self.in_flight = int(self.traffic["in_flight"])
        self.pending = collections.deque()
        self.overflows = []
        img, _ = self.thunk()
        # the kept frames' host buffers (pinned on the card, so that a
        # copy does not wait for the device)
        self.host = [torch.empty(tuple(img.shape), dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
                     for _ in range(int(self.traffic.get("kept_frames",
                                                         4)))]
        self._time_warm(self.thunk)
        self.last = None

    def frame(self, i, win, keep, timed):
        if len(self.pending) >= self.in_flight:
            with span("bench.wait"):
                self.marks.wait(self.pending.popleft())
        t = time.perf_counter()
        with span(self.frame_span):
            img, overflow = self.thunk()
        if timed:
            win.enqueue_s.append(time.perf_counter() - t)
        m = self.marks.mark()
        self.pending.append(m)
        self.overflows.append(overflow)
        self.last = img
        if keep:
            host = self.host[len(win.kept)]
            host.copy_(img, non_blocking=True)
            win.kept.append((0, host))
        return m

    def finish(self, win) -> None:
        self.marks.sync()
        win.kept = [(k, h.numpy()) for k, h in win.kept]
        win.kept.append((0, self.last.cpu().numpy()))
        win.overflow_frames = int(
            torch.stack([o.reshape(()) for o in self.overflows]).ne(0)
            .sum())
        self.pending.clear()
        self.overflows = []
        self.last = None


LOOPS = {"resident": Resident}


def make(traffic, renderer, scenes, params, device, seed) -> Loop:
    return LOOPS[traffic["loop"]](renderer, scenes, params, traffic,
                                  device, seed)
