"""Training launcher: trains a reduced config end to end with the
TensorFrame-curated data pipeline, checkpoints and fault tolerance, on
the CUDA card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --device cpu --steps 20 --ckpt-dir /tmp/ckpt

The JAX launcher's arguments, plus ``--device`` and ``--dtype`` (the
reduced config's weights and compute: float32, or bfloat16).
"""
from __future__ import annotations

import argparse
import logging
from typing import Dict, List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from repro_torch.configs import get
    from repro_torch.core.config import resolve_device
    from repro_torch.data import tokens as tok
    from repro_torch.models.config import reduced
    from repro_torch.train.loop import TrainLoop
    from repro_torch.train.train_step import init_train_state, make_train_step

    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg, microbatches=2, param_dtype=args.dtype, compute_dtype=args.dtype)

    # --- the paper's technique, in the data plane ---
    corpus = tok.synthetic_corpus(2000, seed=args.seed)
    doc_ids, weights = tok.curate(
        corpus, mixture={"web": 1.0, "books": 2.0, "wiki": 1.5, "code": 1.0}, device=dev)
    print(f"curated corpus: {len(doc_ids)} docs after filter/dedup")

    data = (
        {k: torch.as_tensor(v, dtype=torch.int64, device=dev) for k, v in b.items()}
        for b in tok.token_batches(
            doc_ids, weights, cfg.vocab, args.batch, args.seq, seed=args.seed,
            steps=args.steps + 5,
        )
    )
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(args.seed), device=dev)
    loop = TrainLoop(
        make_train_step(cfg), state, data,
        ckpt_dir=args.ckpt_dir or None,
        ckpt_every=args.ckpt_every,
        device=dev,
    )
    loop.install_signal_handler()
    out = loop.run(args.steps)
    losses = [m["loss"] for m in out["metrics"]]
    for i, m in enumerate(out["metrics"]):
        if i % args.log_every == 0 or i == len(out["metrics"]) - 1:
            print(f"step {i}: loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f}")
    if losses:
        print(
            f"done: arch={cfg.name} device={dev} steps={out['final_step']} loss "
            f"{losses[0]:.3f} -> {losses[-1]:.3f} stragglers_skipped={out['stragglers_skipped']}"
        )
    return out


if __name__ == "__main__":
    main()
