"""Training runtime of the port: optimizers, the microbatched train step,
checkpoints, and the fault-tolerant loop (``repro/train``)."""
