"""The 95th percentile of the latency of every query of the window, in
ms: from its issue to its result's columns on the host.  A failed query
is missing: it counts as the window's length, slower than any (end to
end)."""
import statistics


def p95(values) -> float:
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def read(ctx):
    lat = [ctx["window_s"] * 1e3 if x is None else x for x in ctx["latencies_ms"]]
    return p95(lat) if lat else None
