"""LM data pipeline built on the paper's technique (``repro/data/tokens.py``):
the port's TensorFrame is the relational layer for corpus curation —
quality-filter UDFs, dedup group-bys, a metadata join and mixture
re-weighting run as dataframe ops before tokens are batched.

``synthetic_corpus`` and ``token_batches`` are copies of the JAX
package's, with the same numpy draws.  ``curate`` runs the same plan on
``repro_torch.core.TensorFrame`` on the asked device (the CUDA card unless
the caller asks for the CPU), with the same result: on the card its
group-by ``size`` launches the segment sum (K1), and its ``str.contains``
filters the substring kernel (K2).  For that the snippet column stays
offloaded and its filters run on the packed rows (the engine's
``use_device_strings`` path, set for the filter alone): its dictionary of
5 strings is far below the size from which the engine packs a
dictionary, so the default path would test the 5 strings on the host.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def synthetic_corpus(n_docs: int = 2000, seed: int = 0) -> Dict[str, np.ndarray]:
    """A toy document-metadata table: id, source, quality score, lang,
    length, and a comment-ish snippet for UDF filtering."""
    rng = np.random.default_rng(seed)
    sources = np.array(["web", "books", "code", "wiki", "forums"], dtype=object)
    langs = np.array(["en", "de", "fr", "zh"], dtype=object)
    snippets = np.array(
        ["clean text", "buzzword spam click here", "high quality prose",
         "lorem ipsum filler", "duplicate boilerplate header"], dtype=object,
    )
    return {
        "doc_id": np.arange(n_docs, dtype=np.int64),
        "source": sources[rng.integers(0, len(sources), n_docs)],
        "quality": np.round(rng.uniform(0, 1, n_docs), 3),
        "lang": langs[rng.choice(len(langs), n_docs, p=[0.7, 0.1, 0.1, 0.1])],
        "length": rng.integers(50, 4000, n_docs),
        "snippet": snippets[rng.integers(0, len(snippets), n_docs)],
        "dup_group": rng.integers(0, n_docs // 3, n_docs),
    }


def curate(corpus: Dict[str, np.ndarray], mixture: Optional[Dict[str, float]] = None,
           device=None):
    """The dataframe-powered curation plan:

    1. stateless UDF quality filter (paper §IV-A),
    2. dedup: keep the best-quality doc per dup_group (group-by + join),
    3. per-source mixture re-weighting (group-by sizes -> weights).

    Returns (doc_ids, weights) for the batcher, as numpy arrays."""
    from ..core import CONFIG, TensorFrame, col

    f = TensorFrame.from_arrays(corpus, encode={"snippet": "obj"}, device=device)
    device_strings, CONFIG.use_device_strings = CONFIG.use_device_strings, True
    try:
        f = f.filter(
            (col("quality") > 0.25)
            & (col("lang") == "en")
            & (col("length") >= 100)
            & ~col("snippet").str.contains("spam")
            & ~col("snippet").str.contains("boilerplate")
        )
    finally:
        CONFIG.use_device_strings = device_strings
    best = f.groupby("dup_group").agg([("best_q", "max", "quality")])
    f = f.join(best, on="dup_group")
    f = f.filter(col("quality") == col("best_q"))
    sizes = f.groupby("source").agg([("n", "size", "")])
    src_n = dict(zip(sizes.column("source"), sizes.column("n")))
    mixture = mixture or {s: 1.0 for s in src_n}
    doc_ids = f.column("doc_id")
    srcs = f.column("source")
    weights = np.array(
        [mixture.get(s, 0.0) / max(1, src_n.get(s, 1)) for s in srcs], dtype=np.float64
    )
    weights = weights / weights.sum()
    return doc_ids.astype(np.int64), weights


def token_batches(
    doc_ids: np.ndarray,
    weights: np.ndarray,
    vocab: int,
    batch: int,
    seq: int,
    seed: int = 0,
    steps: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Sample docs by mixture weight; synthesize deterministic token
    streams per doc id (stand-in for a real tokenizer/shard reader)."""
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        picks = rng.choice(doc_ids, size=batch, p=weights)
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        for b, did in enumerate(picks):
            drng = np.random.default_rng(int(did) * 1_000_003 + i)
            toks[b] = drng.integers(0, vocab, seq + 1)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        i += 1
