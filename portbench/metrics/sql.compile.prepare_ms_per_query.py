"""Host milliseconds a completed query spends before its graph's replay:
the program's ``sql.compile.prepare`` spans (scans, table prep, unique
requests, parameters, fingerprint, cache lookup) in the traced window
over the queries completed in it (compiled SQL; moves
``queries_per_s``)."""
from portbench import spans


def recorder():
    return spans.recorder()


def read(ctx):
    return spans.ms_per_query(ctx, ("sql.compile.prepare",))
