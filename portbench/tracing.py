"""The traced run: ``torch.profiler`` over the measured window, reduced to
the device's busy time, its idle gaps and its time by kernel name.

The benchmark marks the window and each query with ``record_function``
spans of its own (``portbench.window``, ``portbench.<query>``); the
program's code is not touched.  Busy time is the union of the intervals
in which a device operation (kernel, copy, memset) ran, clipped to the
window, so overlapping operations count once.  A profiler session can
lose the first device events it records, so a session opens with short
pad kernels, which fall before the window and are left out.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

WINDOW = "portbench.window"
QUERY = "portbench."
PAD_KERNELS = 64
PAD_CYCLES = 1000
TOP = 10


class Tracer:
    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.torch = torch
        self._record = record_function
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.__enter__()
        for _ in range(PAD_KERNELS):
            self.torch.cuda._sleep(PAD_CYCLES)
        self.torch.cuda.synchronize()

    def span(self, name: str):
        return self._record(name)

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def reduce(self) -> dict:
        # the profiler's raw events: reading them skips building a Python
        # event tree, which takes minutes over a window of eager queries
        raw = self._prof.profiler.kineto_results.events()
        return reduce_events(
            (e.name(), e.device_type(), e.start_ns() * 1e-3, e.end_ns() * 1e-3,
             bool(e.is_user_annotation()))
            for e in raw
        )


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events) -> dict:
    """Busy seconds, window seconds, seconds by device operation, and the
    longest idle gaps named by what the host was doing, from profiler
    events as (name, device type, start us, end us, is a user annotation).
    The benchmark's own spans also show on the device's timeline as
    annotations: they are not device work."""
    from torch.autograd import DeviceType

    w0 = w1 = None
    spans: List[Tuple[float, float, str]] = []
    host_ops: List[Tuple[float, float, str]] = []
    dev: List[Tuple[float, float, str]] = []
    for name, kind, s, t, annotation in events:
        if kind == DeviceType.CUDA:
            if not annotation and not name.startswith(QUERY):
                dev.append((s, t, name))
        elif name == WINDOW:
            w0, w1 = s, t
        elif name.startswith(QUERY):
            spans.append((s, t, name[len(QUERY):]))
        else:
            host_ops.append((s, t, name))
    if w0 is None:
        raise RuntimeError("the trace holds no window span")
    by_op: Dict[str, float] = {}
    clipped = []
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            clipped.append((s, t))
            by_op[name] = by_op.get(name, 0.0) + (t - s) * 1e-6
    union = _merge(clipped)
    busy = sum(t - s for s, t in union) * 1e-6
    gaps, prev = [], w0
    for s, t in union + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, t)
    gaps.sort(reverse=True)
    named = []
    for length, s, t in gaps[:TOP]:
        mid = (s + t) / 2
        query = next((n for a, b, n in spans if a <= mid <= b), "between queries")
        inner = [(a, n) for a, b, n in host_ops if a <= mid <= b]
        op = max(inner)[1] if inner else "no host op"
        named.append([f"{query}: {op}", length * 1e-6])
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy,
        "window_s": (w1 - w0) * 1e-6,
        "by_op": by_op,
        "device_ops": [[k, v] for k, v in top_ops],
        "idle_gaps": named,
    }

