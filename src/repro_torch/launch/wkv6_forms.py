"""Time K5's two forward forms on the card over the number of steps: the
serial kernel (``csrc/wkv6.cu``, launch name ``wkv6``) and the chunked
one (``csrc/wkv6_chunked.cu``, ``wkv6_chunked``), to place
``kernels.wkv6.CHUNKED_MIN_T`` where the chunked form starts to win.

    PYTHONPATH=src python3 src/repro_torch/launch/wkv6_forms.py [--out FILE]

At RWKV6-7B's heads (H 64, D 64), bf16 r/k/v/w as the model hands them
over (strided (B, H, T, D) views of (B, T, H, D)), bf16 u and a float32
state written over itself, for B 1 and 4 and T from 1 to 4096: each
form's ms per call (CUDA events over warm calls).  Prints the build's
ptxas report of the chunked kernel, then one JSON line (also written to
``--out``) with the card's name and power limit.  The forms are checked
against the plain version by ``chip_smoke.py`` and the card tests;
variants of the chunked source are compared by
``launch/kernel_variants.py wkv6_chunked``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6 import FORWARD_FORMS, _wkv6_launch
from repro_torch.launch.kernel_variants import event_ms, wkv6_inputs

STEPS = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 256, 512, 1024, 4096)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wkv6_forms: no CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    print(build.BUILD_LOG.get("wkv6_chunked", ""), flush=True)
    rng = np.random.default_rng(0)
    out = {"times": []}
    for B in (1, 4):
        for T in STEPS:
            r, k, v, w, u, s0 = wkv6_inputs(rng, torch.bfloat16, B, 64, T, 64)
            row = {"B": B, "T": T}
            for form in FORWARD_FORMS:
                reps = 200 if T <= 128 else 20
                row[form] = event_ms(
                    lambda: _wkv6_launch(form, r, k, v, w, u, s0, state_out=s0), reps)
            print(json.dumps(row), flush=True)
            out["times"].append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["device"] = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
