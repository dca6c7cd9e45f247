"""Host milliseconds a completed query spends in the SQL front end: the
program's ``sql.parse``, ``sql.plan`` and ``sql.optimize`` spans in the
traced window over the queries completed in it (SQL front end; moves
``queries_per_s``)."""
from portbench import spans

NAMES = ("sql.parse", "sql.plan", "sql.optimize")


def recorder():
    return spans.recorder()


def read(ctx):
    return spans.ms_per_query(ctx, NAMES)
