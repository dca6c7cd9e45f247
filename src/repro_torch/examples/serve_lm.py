"""Batched serving example: continuous-batching decode over a pool of
requests (slots refill as requests finish).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The weights are drawn from a ``torch.Generator`` seeded with 0 on the
CPU and moved to the device, so the card and the CPU serve the same
model.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.core import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.serve.engine import Request, ServeEngine

SLOTS = 4
N_REQUESTS = 12


def config() -> ModelConfig:
    """Reduced ``phi3-mini-3.8b``: 4 layers, d_model 128, vocab 2048."""
    return reduced(get("phi3-mini-3.8b"), n_layers=4, d_model=128, n_heads=4,
                   n_kv_heads=4, head_dim=32, d_ff=256, vocab=2048)


def requests(cfg: ModelConfig) -> List[Request]:
    """The script's 12 requests: prompts of 3 to 9 tokens, 4 to 11 new
    tokens each, drawn from seed 0."""
    rng = np.random.default_rng(0)
    return [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(3, 10)).astype(np.int32),
                max_new=int(rng.integers(4, 12)))
        for i in range(N_REQUESTS)
    ]


def run(device=None, params: Optional[lm.Params] = None) -> Dict:
    """The script's work on ``device`` (default ``CONFIG.device``), with
    ``params`` (on that device) in place of the seeded weights where
    given: ``{"lines": what it prints, "requests": the served requests,
    "steps": decode steps, "seconds": the serving wall time}``."""
    dev = resolve_device(device)
    cfg = config()
    if params is None:
        params = lm.init_params(cfg, torch.Generator("cpu").manual_seed(0), device="cpu").to(dev)
    eng = ServeEngine(cfg, params, batch_slots=SLOTS, max_len=128)
    reqs = requests(cfg)
    t0 = time.time()
    eng.run(reqs, max_steps=600)
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    lines = [f"served {done}/{len(reqs)} requests, {toks} tokens in {dt:.1f}s "
             f"({eng.steps} decode steps over {SLOTS} slots)"]
    for r in reqs[:3]:
        lines.append(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return {"lines": lines, "requests": reqs, "steps": eng.steps, "seconds": dt}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print("\n".join(out["lines"]))
    return out


if __name__ == "__main__":
    main()
