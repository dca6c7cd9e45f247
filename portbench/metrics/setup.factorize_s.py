"""Host seconds of set-up spent factorizing string columns while loading
the tables: the program's ``core.load`` counter ``factorize_s`` (through
``repro_torch.obs.metrics``), which only loading moves (storage and
loading; moves ``setup_s``).  Nothing to read in a program without the
counter."""


def read(ctx):
    import repro_torch.obs.metrics as obs_metrics

    return obs_metrics.snapshot().get("core.load", {}).get("factorize_s")
