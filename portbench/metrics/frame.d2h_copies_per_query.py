"""Copies from the device to the host a completed query makes: the
growth of the program's counter ``frame.d2h_copies`` (through
``repro_torch.obs.metrics``) over the window, over the queries completed
in it (query scripts; moves ``queries_per_s``).  Nothing to read in a
program without the counter."""
from portbench import spans


def recorder():
    return spans.Counters()


def read(ctx):
    grew = ctx["recorded"].grew("obs", "frame.d2h_copies")
    if grew is None or not ctx["completed"]:
        return None
    return grew / ctx["completed"]
