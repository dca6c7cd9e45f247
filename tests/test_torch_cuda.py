"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and a query on the card against the CPU path.

Every test needs a CUDA device and skips without one.  The file imports
neither jax nor the JAX package, so it also runs on a machine without
them (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.data import tpch
from repro_torch.kernels import ops
from repro_torch.kernels.segment_reduce import segment_sum_cuda, segment_sum_plain
from repro_torch.kernels.substr_find import substr_find_cuda, substr_find_plain
from repro_torch.queries import tpch_frames

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64])
@pytest.mark.parametrize("n,m", [(1, 1), (10_000, 4), (10_000, 4096), (10_000, 50_000)])
def test_segment_sum_kernel_matches_plain(cuda_device, dtype, n, m):
    rng = np.random.default_rng(n + m)
    ids = torch.as_tensor(rng.integers(-1, m + 1, n), device=cuda_device)  # -1, m dropped
    vals = torch.as_tensor(rng.normal(size=n) * 100, device=cuda_device).to(dtype)
    got = segment_sum_cuda(vals, ids, m)
    want = segment_sum_plain(vals, ids, m)
    if dtype == torch.int64:
        assert torch.equal(got, want)
    else:
        # float atomics add in an order that changes from run to run
        rtol = 1e-12 if dtype == torch.float64 else 1e-4
        torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("pat", ["", "a", "special", "x" * 130])
def test_substr_find_kernel_matches_plain(cuda_device, pat):
    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"abspecialx yz", dtype=np.uint8)
    packed = torch.as_tensor(alphabet[rng.integers(0, alphabet.size, (2000, 128))], device=cuda_device)
    lens = torch.as_tensor(rng.integers(0, 129, 2000).astype(np.int32), device=cuda_device)
    start = torch.as_tensor(rng.integers(-1, 100, 2000).astype(np.int32), device=cuda_device)
    p = torch.tensor(list(pat.encode()), dtype=torch.uint8, device=cuda_device)
    for st in (None, start):
        assert torch.equal(substr_find_cuda(packed, lens, p, st), substr_find_plain(packed, lens, p, st))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    v = torch.zeros(4, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        segment_sum_cuda(v, torch.zeros(4, dtype=torch.int32, device=cuda_device), 2)
    with pytest.raises(ValueError):
        segment_sum_cuda(torch.zeros((4, 2), dtype=torch.float64, device=cuda_device)[:, 0],
                         torch.zeros(4, dtype=torch.int64, device=cuda_device), 2)
    with pytest.raises(ValueError):
        segment_sum_cuda(v, torch.zeros(4, dtype=torch.int64), 2)


@pytest.mark.parametrize("qname", ["q1", "q13", "q16", "q18"])
def test_query_on_the_card_matches_the_cpu_path(cuda_device, qname):
    tables = tpch.generate(sf=0.01, seed=1)
    ops.reset_launches()
    got = tpch_frames.ALL[qname](tpch.as_frames(tables, device=cuda_device), sf=0.01)
    assert ops.LAUNCHES["segment_sum"] > 0
    want = tpch_frames.ALL[qname](tpch.as_frames(tables, device="cpu"), sf=0.01)
    got, want = got.to_dict(), want.to_dict()
    assert list(got) == list(want)
    for c in want:
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], rtol=1e-8, atol=0)
        else:
            np.testing.assert_array_equal(got[c], want[c])
