"""Seconds to load every table onto the device: the benchmark's clock
around ``TensorFrame.from_arrays`` of each table, ending in a
synchronize (storage and loading; moves ``setup_s``)."""


def read(ctx):
    return ctx["client"]["load_s"]
