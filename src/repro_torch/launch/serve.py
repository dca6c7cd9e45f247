"""Serving launcher: batched continuous-batching decode on a reduced
config, on the CUDA card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --requests 16 --slots 4 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> List:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get
    from repro_torch.core.config import resolve_device
    from repro_torch.models import lm
    from repro_torch.models.config import reduced
    from repro_torch.serve.engine import Request, ServeEngine

    dev = resolve_device(args.device)
    cfg = reduced(get(args.arch))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(args.seed), device=dev)
    eng = ServeEngine(cfg, params, batch_slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, rng.integers(3, 12)).astype(np.int32),
            max_new=args.max_new,
        )
        for i in range(args.requests)
    ]
    t0 = time.time()
    eng.run(reqs, max_steps=2000)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in reqs)
    print(
        f"arch={cfg.name} device={dev} served {sum(r.done for r in reqs)}/{len(reqs)} "
        f"requests, {toks} tokens, {eng.steps} decode steps over {args.slots} slots "
        f"in {dt:.1f}s"
    )
    return reqs


if __name__ == "__main__":
    main()
