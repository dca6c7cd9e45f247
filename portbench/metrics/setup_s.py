"""Seconds from process start to the first timed query: imports, the
kernels' load (their build on a checkout's first run), generation from
the seed, loading onto the device, and the warm-up rounds of the cell's
own queries (end to end)."""


def read(ctx):
    return ctx["setup_s"]
