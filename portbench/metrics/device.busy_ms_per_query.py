"""Device-busy milliseconds per completed query: the union of the
intervals in which a kernel, copy or memset ran in the traced window,
over the queries completed in it (device; moves ``queries_per_s``)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["completed"]:
        return None
    return t["busy_s"] * 1e3 / ctx["completed"]
