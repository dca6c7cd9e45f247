"""Queries completed in the window over its seconds (end to end)."""


def read(ctx):
    return ctx["completed"] / ctx["window_s"] if ctx["window_s"] > 0 else 0.0
