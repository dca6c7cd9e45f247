"""Share of the traced window in which no device operation ran:
100 x (1 - busy / window) (device; moves ``queries_per_s``)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
