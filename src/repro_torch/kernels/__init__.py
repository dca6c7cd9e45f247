"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the device dispatch (``ops``).  Sources are under ``csrc/`` and are
built with ``nvcc`` at first use (``build``)."""
