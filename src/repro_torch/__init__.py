"""TensorFrame on PyTorch and CUDA: the port of the JAX package ``repro``.

The modules mirror the JAX package's paths (``repro_torch/core/join.py``
ports ``repro/core/join.py``).  Entry points run on the CUDA device
unless the caller asks for the CPU (``device="cpu"``); the group-by sum
and the substring predicates run through hand-written CUDA kernels
(``repro_torch.kernels``).
"""

import torch as _torch

# PyTorch's CPU exp goes through MKL's vector math.  When the first exp
# of a process runs on several threads at once, MKL can return values
# good to about 12 bits (relative error up to 1.5e-4, seen with MKL
# 2024.2); later calls are exact to float32 rounding.  One small call on
# one thread first avoids it.
_torch.exp(_torch.zeros(1))
