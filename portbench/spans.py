"""The program's own spans and counters over the measured window, for
the readers of per-layer metrics whose source is ``program_span`` or
``program_counter``.

A reader's ``recorder()`` returns ``recorder()`` from here: it turns the
port's tracer on (``CONFIG.tracing = "on"``) and marks the tracer's
clock; ``stop()`` takes the spans recorded since the mark and puts the
tracer's previous mode back.  ``run.py`` makes recorders after the
profiler starts and stops them before it stops, so the program traces
only inside a ``--trace 1`` window, and a ``--trace 0`` run never turns
tracing on.  Several readers share one window: the first recorder made
turns tracing on, the last one stopped turns it back.  A counter's
reader returns ``Counters()`` instead: the program's ``obs.metrics``
snapshot at the window's start and at its end.
"""
from __future__ import annotations

from typing import Iterable, Optional

_OPEN: list = []  # recorders made and not yet stopped
_SAVED: list = []  # the tracer's mode before the first of them


class Recorder:
    def __init__(self):
        from repro_torch import obs
        from repro_torch.core.config import CONFIG

        self._obs, self._cfg = obs, CONFIG
        if not _OPEN:
            _SAVED[:] = [CONFIG.tracing]
            CONFIG.tracing = "on"
        _OPEN.append(self)
        self.spans, self.dropped = None, None
        self._dropped0 = obs.dropped()
        self._mark = obs.mark_ns()

    def stop(self):
        self.spans = self._obs.spans(since_ns=self._mark)
        self.dropped = self._obs.dropped() - self._dropped0
        _OPEN.remove(self)
        if not _OPEN:
            self._cfg.tracing = _SAVED.pop()


def recorder() -> Recorder:
    return Recorder()


def ms_per_query(ctx: dict, names: Iterable[str]) -> Optional[float]:
    """Milliseconds a completed query of the window spent in the spans
    named ``names``; None where the tracer dropped spans in the window,
    no query completed, or no such span occurred (a program without it)."""
    rec, names = ctx["recorded"], set(names)
    if rec is None or rec.spans is None or rec.dropped or not ctx["completed"]:
        return None
    durs = [s.dur_ns for s in rec.spans if s.name in names]
    if not durs:
        return None
    return sum(durs) * 1e-6 / ctx["completed"]


class Counters:
    """The program's counters (``repro_torch.obs.metrics``) at the
    window's start and at its end."""

    def __init__(self):
        import repro_torch.obs.metrics as obs_metrics

        self._m = obs_metrics
        self.before, self.after = obs_metrics.snapshot(), None

    def stop(self):
        self.after = self._m.snapshot()

    def grew(self, group: str, key: str) -> Optional[float]:
        """How far ``group``'s ``key`` grew over the window; None in a
        program without it."""
        after = self.after.get(group, {}).get(key)
        if after is None:
            return None
        return after - self.before.get(group, {}).get(key, 0)
