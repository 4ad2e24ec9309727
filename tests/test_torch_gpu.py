"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). Run on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: exact. Indices and scores are integers, and the order
(score desc, row asc) is total.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_plain,
)
from repro_torch.kernels.topk_hamming import topk_hamming, topk_hamming_plain

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _bank(rng, rows, d, packed, dup=False):
    hv = rng.choice([-1, 1], size=(rows, d)).astype(np.int8)
    if dup:
        hv = np.concatenate([hv, hv, hv])
    t = torch.from_numpy(hv)
    return bitpack_bipolar(t) if packed else t


# (Q, R, D, packed, k, num_valid, duplicates)
CASES = [
    (32, 3000, 8192, True, 4, None, False),
    (5, 1000, 256, True, 7, 600, False),      # ragged Q, num_valid < R
    (40, 517, 64, True, 20, 9, False),        # k > num_valid
    (3, 37, 32, True, 37, None, False),       # k = R
    (17, 300, 96, True, 9, None, True),       # duplicate rows: tied scores
    (32, 2000, 1000, False, 4, None, False),  # int8 at D = 1000
    (9, 129, 1000, False, 129, 77, True),     # int8, k = R, ties, masked
    (4, 70, 13, False, 5, None, False),       # int8, D % 4 != 0
]


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup", CASES)
def test_topk_hamming_kernel_matches_plain(cuda, Q, R, D, packed, k, nv, dup):
    rng = np.random.default_rng(Q * 1000 + R + D)
    bank = _bank(rng, R // 3 if dup else R, D, packed, dup).to(cuda)
    q = _bank(rng, Q, D, packed).to(cuda)
    got = topk_hamming(q, bank, dim=D, k=k, num_valid=nv)
    want = topk_hamming_plain(q, bank, dim=D, k=k, num_valid=nv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup", CASES)
def test_encode_search_kernel_matches_plain(cuda, Q, R, D, packed, k, nv,
                                            dup):
    rng = np.random.default_rng(Q * 7 + R + D)
    F, m = 300, 16
    id_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(F, D)).astype(np.int8)).to(cuda)
    lv_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(m, D)).astype(np.int8)).to(cuda)
    levels = rng.integers(0, m, size=(Q, F))
    levels[:, rng.random(F) < 0.7] = 0       # sparse spectra
    levels[0] = 0                             # an empty spectrum
    levels[-1, :3] = m + 2                    # past the codebook: LV[m-1]
    levels = torch.from_numpy(levels.astype(np.int32)).to(cuda)
    bank = _bank(rng, R // 3 if dup else R, D, packed, dup).to(cuda)
    got = encode_search(levels, id_hvs, lv_hvs, bank, dim=D, k=k,
                        num_valid=nv)
    want = encode_search_plain(levels, id_hvs, lv_hvs, bank, dim=D, k=k,
                               num_valid=nv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
