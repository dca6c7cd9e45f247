"""End to end: curate a corpus with the TensorFrame relational
engine, then train a ~100M-parameter qwen3-family model for a few
hundred steps with checkpointing + fault tolerance.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--ckpt-dir DIR] [--device cpu]

On the card the curation's group-bys sum through the segment-sum kernel
(K1), its substring filters run the substring kernel (K2), and each
step runs the attention kernel (K4) forward and backward.  A checkpoint
directory that holds a checkpoint is resumed from; the default one is
``repro_torch_train_lm`` under the temporary directory.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get
from repro_torch.core import resolve_device
from repro_torch.data import tokens as tok
from repro_torch.models.config import ModelConfig, reduced
from repro_torch.train.loop import TrainLoop
from repro_torch.train.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
MIXTURE = {"web": 1.0, "books": 2.0, "wiki": 1.5, "code": 1.0}
BATCH, SEQ = 8, 128


def config(**overrides) -> ModelConfig:
    """Reduced ``qwen3-14b``: 10 layers, d_model 640, vocab 32064, about
    100 M parameters; ``overrides`` replace any of these."""
    shape = dict(n_layers=10, d_model=640, n_heads=8, n_kv_heads=4, head_dim=64,
                 d_ff=2048, vocab=32064, microbatches=2, q_chunk=256)
    shape.update(overrides)
    return reduced(get("qwen3-14b"), **shape)


def run(steps: int = 300, ckpt_dir: str = DEFAULT_CKPT_DIR, device=None,
        overrides: Optional[Dict] = None) -> Dict:
    """The script's work on ``device`` (default ``CONFIG.device``):
    ``{"lines": what it prints, "losses": each step's loss, "final_step",
    "seconds": the loop's wall time, "cfg"}``.  Raises ``AssertionError``
    when the last loss is not below the first, as the script does."""
    dev = resolve_device(device)
    cfg = config(**(overrides or {}))
    lines = [f"model: {cfg.name}-reduced, {cfg.param_count()/1e6:.1f}M params"]

    corpus = tok.synthetic_corpus(4000, seed=1)
    doc_ids, weights = tok.curate(corpus, mixture=MIXTURE, device=dev)
    lines.append(f"TensorFrame curation: {len(doc_ids)} docs survive filter+dedup")

    data = (
        {k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}
        for b in tok.token_batches(doc_ids, weights, cfg.vocab, BATCH, SEQ, steps=steps + 2)
    )
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    loop = TrainLoop(make_train_step(cfg), state, data, ckpt_dir=ckpt_dir, ckpt_every=100,
                     device=dev)
    loop.install_signal_handler()
    t0 = time.time()
    out = loop.run(steps)
    dt = time.time() - t0
    losses = [m["loss"] for m in out["metrics"]]
    lines.append(f"steps={out['final_step']} in {dt:.0f}s ({BATCH*SEQ*len(losses)/dt:.0f} tok/s)")
    lines.append(f"loss: {losses[0]:.3f} -> {min(losses):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not improve")
    return {"lines": lines, "losses": losses, "final_step": out["final_step"], "seconds": dt,
            "cfg": cfg}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.steps, args.ckpt_dir, args.device)
    print("\n".join(out["lines"]))
    return out


if __name__ == "__main__":
    main()
