"""Share of the window's SQL executions that replayed a cached graph:
hits over hits, misses, fallbacks and inputs too small to compile, from
the diff of ``repro_torch.sql.compile.STATS`` (read through
``repro_torch.obs.metrics``) over the window (compiled SQL; moves
``queries_per_s``).  Nothing to read where no SQL ran."""


class Recorder:
    """The program's counters at the window's start and its end."""

    def __init__(self):
        import repro_torch.obs.metrics as obs_metrics

        self._m = obs_metrics
        self.before, self.after = obs_metrics.snapshot(), None

    def stop(self):
        self.after = self._m.snapshot()


def recorder():
    return Recorder()


def read(ctx):
    rec = ctx["recorded"]
    s = rec._m.diff(rec.before, rec.after).get("sql.compile", {})
    hits = s.get("hits", 0)
    total = hits + s.get("misses", 0) + s.get("fallbacks", 0) + s.get("skipped_small", 0)
    return 100.0 * hits / total if total else None
