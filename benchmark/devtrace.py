"""The traced run's readings of the device and the host.

`DeviceTrace` records the card's activity with torch.profiler (CUDA
activity only: kernels, copies and sets, without the host's operator
events, so that a window of hundreds of statements stays cheap to
record and read). `HostSampler` samples the server process's Python
threads every few milliseconds, so that an idle gap on the device can be
named by what the host was doing in it. Both stamp wall-clock
nanoseconds, the profiler's own clock.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

# a thread whose innermost frame is one of these waits (for a client, a
# lock, a queue or a timer) and does no work
_WAIT_FILES = ("threading.py", "queue.py", "selectors.py", "socket.py",
               "connection.py", "synchronize.py")
_WAIT_FUNCS = {"_recv_exact", "accept", "sleep", "wait", "_wait_for_tstate_lock"}


def is_kernel(name: str) -> bool:
    """A device op that is a kernel launch, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


class DeviceTrace:
    """torch.profiler over the card's activity in one window."""

    def __init__(self):
        self._prof = None
        self.ops: list = []       # (name, start_ns, end_ns), device ops

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns()))
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self._prof = None

    def clipped(self, w0: int, w1: int) -> list:
        """Device ops overlapping [w0, w1], clipped to it."""
        return [(n, max(s, w0), min(e, w1)) for n, s, e in self.ops
                if e > w0 and s < w1]


def busy_intervals(ops: list) -> list:
    """The union of the ops' [start, end) intervals, sorted."""
    out = []
    for _n, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class HostSampler:
    """Samples every thread of this process but its own: for each
    working thread, the innermost frame in the program's package."""

    PERIOD_S = 0.005
    PACKAGE = os.sep + "tidb_tpu_torch" + os.sep

    def __init__(self):
        self.samples: list = []      # (wall ns, [label, ...])
        self._stop = threading.Event()
        self._thread = None

    def _label(self, frame):
        f = frame
        code = f.f_code
        if code.co_name in _WAIT_FUNCS or \
                os.path.basename(code.co_filename) in _WAIT_FILES:
            return None
        leaf = f"{os.path.basename(code.co_filename)}:{code.co_name}"
        while f is not None:
            fn = f.f_code.co_filename
            if self.PACKAGE in fn:
                mod = fn.split(self.PACKAGE, 1)[1].removesuffix(".py")
                own = f"{mod}:{f.f_code.co_name}"
                return own if f is frame else f"{own} > {leaf}"
            f = f.f_back
        return None

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.is_set():
            now = time.time_ns()
            labels = []
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                lab = self._label(frame)
                if lab is not None:
                    labels.append(lab)
            self.samples.append((now, labels))
            time.sleep(self.PERIOD_S)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bench-host-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def label_between(self, s: int, e: int) -> str:
        """The most frequent work label among samples in [s, e]."""
        cnt = collections.Counter()
        for t, labels in self.samples:
            if s <= t <= e:
                cnt.update(labels)
        if not cnt:
            return "host: no program thread working"
        return "host: " + cnt.most_common(1)[0][0]


def breakdown(ops: list, w0: int, w1: int, sampler: HostSampler | None,
              top: int = 10) -> dict:
    """The traced window's device ops that took most time, and its
    longest idle gaps named by what the host was doing."""
    by_name = collections.Counter()
    for n, s, e in ops:
        by_name[n] += (e - s) / 1e9
    busy = busy_intervals(ops)
    gaps = []
    prev = w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = []
    for s, e in gaps[:top]:
        name = sampler.label_between(s, e) if sampler is not None \
            else "host: not sampled"
        idle.append([name, (e - s) / 1e9])
    return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
            "idle_gaps": idle}
