"""The port's CUDA kernels (exact and banded) against their plain PyTorch
versions, on the card.

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
from repro_torch.core.hd.similarity import INT32_MIN
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_banded,
    encode_search_banded_plain,
    encode_search_plain,
)
from repro_torch.kernels.topk_hamming import (
    topk_hamming,
    topk_hamming_banded,
    topk_hamming_banded_plain,
    topk_hamming_plain,
)

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


def _bands(rng, Q, R, kind):
    """(starts, lens): (Q,) for one band, (2, Q) for two."""
    if kind == "random":       # empty, narrow and wide bands, some past R
        starts = rng.integers(-3, R + 1, Q)
        lens = rng.integers(0, R // 2 + 1, Q)
    elif kind == "narrow":     # narrower than k, some empty
        starts, lens = rng.integers(0, R - 3, Q), rng.integers(0, 3, Q)
    elif kind == "far_apart":  # inside each 8-query block, both bank ends
        starts = np.where(np.arange(Q) % 2 == 0, 5, R - 700)
        lens = np.full(Q, 600)
    elif kind == "wide":       # many tiles: the window crosses splits
        starts, lens = rng.integers(0, 200, Q), rng.integers(R // 2, R, Q)
    elif kind == "two":        # two disjoint bands per query
        s0 = rng.integers(0, R // 3, Q)
        s1 = rng.integers(R // 2, R - 10, Q)
        starts = np.stack([s0, s1])
        lens = np.stack([rng.integers(0, R // 4, Q), rng.integers(0, R, Q)])
        lens[1] = np.minimum(lens[1], R - s1)
    return (torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(lens.astype(np.int32)))


# (Q, R, D, packed, k, num_valid, duplicates, bands, num_tiles)
BANDED_CASES = [
    (32, 3000, 8192, True, 4, None, False, "wide", None),
    (5, 1000, 256, True, 7, 600, False, "random", None),  # ragged Q, nv < R
    (40, 517, 64, True, 20, 9, False, "random", 1),       # k > num_valid
    (16, 400, 96, True, 9, None, True, "narrow", None),   # ties, bands < k
    (16, 5000, 256, True, 4, None, False, "far_apart", 8),  # budget too small
    (24, 2000, 256, True, 5, 1900, False, "two", None),   # two bands
    (32, 2000, 1000, False, 4, None, False, "wide", None),  # int8 D = 1000
    (9, 129, 1000, False, 129, 77, True, "two", None),    # int8, k = R, ties
]


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup,kind,nt", BANDED_CASES)
def test_topk_hamming_banded_kernel_matches_plain(cuda, Q, R, D, packed, k,
                                                  nv, dup, kind, nt):
    rng = np.random.default_rng(Q * 1000 + R + D + 1)
    bank = _bank(rng, R // 3 if dup else R, D, packed, dup).to(cuda)
    q = _bank(rng, Q, D, packed).to(cuda)
    starts, lens = (t.to(cuda) for t in _bands(rng, Q, bank.shape[0], kind))
    want = topk_hamming_banded_plain(q, bank, starts, lens, dim=D, k=k,
                                     num_valid=nv)
    got = topk_hamming_banded(q, bank, starts, lens, dim=D, k=k,
                              num_valid=nv, num_tiles=nt)
    raw = topk_hamming_banded(q, bank, starts, lens, dim=D, k=k,
                              num_valid=nv, num_tiles=nt, canonicalize=False)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    real = raw[1] != INT32_MIN      # fillers differ only in sentinel slots
    assert torch.equal(raw[1], want[1])
    assert torch.equal(raw[0][real], want[0][real])


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup,kind,nt", BANDED_CASES)
def test_encode_search_banded_kernel_matches_plain(cuda, Q, R, D, packed, k,
                                                   nv, dup, kind, nt):
    rng = np.random.default_rng(Q * 7 + R + D + 1)
    F, m = 300, 16
    id_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(F, D)).astype(np.int8)).to(cuda)
    lv_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(m, D)).astype(np.int8)).to(cuda)
    levels = rng.integers(0, m, size=(Q, F))
    levels[:, rng.random(F) < 0.7] = 0
    levels[0] = 0
    levels = torch.from_numpy(levels.astype(np.int32)).to(cuda)
    bank = _bank(rng, R // 3 if dup else R, D, packed, dup).to(cuda)
    starts, lens = (t.to(cuda) for t in _bands(rng, Q, bank.shape[0], kind))
    got = encode_search_banded(levels, id_hvs, lv_hvs, bank, starts, lens,
                               dim=D, k=k, num_valid=nv, num_tiles=nt)
    want = encode_search_banded_plain(levels, id_hvs, lv_hvs, bank, starts,
                                      lens, dim=D, k=k, num_valid=nv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
