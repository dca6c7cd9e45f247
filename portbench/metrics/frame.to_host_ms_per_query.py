"""Milliseconds a completed query spends bringing its result's columns to
the host: the program's ``frame.to_host`` spans (``TensorFrame.to_dict``:
a copy a column, then the dictionary lookups of string columns) in the
traced window over the queries completed in it (query scripts; moves
``query_ms_p95``)."""
from portbench import spans


def recorder():
    return spans.recorder()


def read(ctx):
    return spans.ms_per_query(ctx, ("frame.to_host",))
