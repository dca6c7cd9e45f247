"""Time K2 and two cut-down builds of it on a q13-like dictionary, to see
what bounds it, and print one JSON line.

    PYTHONPATH=src python3 src/repro_torch/launch/substr_variants.py

The builds come from ``kernels/csrc/substr_find.cu`` with one text
substitution each, compiled with ``nvcc`` into ``build/substr_variants``:

* ``kernel``: the source as it is (its results are checked against the
  plain versions);
* ``copies only``: rows are copied into shared memory but not searched
  and no result is written: the memory side alone;
* ``search only``: nothing is copied and the rows' buffers are searched
  as they lie: the instruction side alone (and the lengths' reads).

The dictionary: 1,492,606 comments (q13's ``o_comment`` dictionary at
SF 1) from the generator's ``_rand_words``, 1 % with "special ...
requests" injected by its ``_inject_pattern`` (seed 1), packed to 128
bytes a row.  Each build times the find of "special" and
``exists_before("special", "requests")``; a clone of the packed tensor
gives the card's copy rate.  Times: CUDA events over warm launches, ms
per launch.  Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

REPS = 50
ROWS = 1_492_606
VARIANTS = {
    "kernel": [],
    "copies only": [("    if (live) {\n", "    if (live && sp.chunks < 0) {\n")],
    "search only": [("cp_async16(bufs + q * rowcap + 16 * c, src + 16 * c);", "(void)src;")],
}


def event_ms(fn, reps: int = REPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_variant(build, name: str, subs):
    """The C entry point of the K2 source with ``subs`` applied."""
    text = (build.CSRC / "substr_find.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
        text = text.replace(old, new)
    out_dir = build.BUILD_DIR.parent / "substr_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    slug = name.replace(" ", "_")
    src, lib = out_dir / f"{slug}.cu", out_dir / f"{slug}.so"
    src.write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    symbol, argtypes = build.SIGNATURES["substr_find"]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("substr_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import strings
    from repro_torch.data import tpch
    from repro_torch.kernels import build
    from repro_torch.kernels.substr_find import exists_before_plain, substr_find_plain

    dev = torch.device("cuda", 0)
    words = np.random.default_rng(1)
    comments = tpch._inject_pattern(
        words, tpch._rand_words(words, ROWS), "special", "requests", 0.01)
    packed, lens = strings.pack_strings(comments, 128, dev)
    n, L = packed.shape
    pa = torch.tensor(list(b"special"), dtype=torch.uint8, device=dev)
    pb = torch.tensor(list(b"requests"), dtype=torch.uint8, device=dev)
    live = int(torch.clamp(lens, 0, L).sum())
    out = {
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        "rows": n, "L": L, "live_bytes": live,
        # each row's live bytes, its length read and an int32 result written
        "find_bound_ms": (live + 8 * n) / 3.35e12 * 1e3,
        "clone_tb_per_s": 2 * packed.numel() / event_ms(packed.clone) / 1e9,
    }
    found = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, subs in VARIANTS.items():
        fn = build_variant(build, name, subs)

        def find():
            build.check(name, fn(0, packed.data_ptr(), lens.data_ptr(), None, pa.data_ptr(), 7,
                                 None, 0, n, L, found.data_ptr(), stream))

        def exists():
            build.check(name, fn(1, packed.data_ptr(), lens.data_ptr(), None, pa.data_ptr(), 7,
                                 pb.data_ptr(), 8, n, L, hit.data_ptr(), stream))

        if name == "kernel":
            find()
            exists()
            if not (torch.equal(found, substr_find_plain(packed, lens, pa))
                    and torch.equal(hit, exists_before_plain(packed, lens, pa, pb))):
                raise AssertionError("the K2 kernel disagrees with its plain versions")
        out[name] = {"find_ms": event_ms(find), "exists_before_ms": event_ms(exists)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
