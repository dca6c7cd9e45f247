"""Seconds of the first execution of each query of the mix during
set-up: for compiled SQL the trace, the capture of its CUDA graph and
the cold replay (compiled SQL; moves ``setup_s``)."""


def read(ctx):
    return ctx["stages"]["first_executions_s"]
