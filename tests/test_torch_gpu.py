"""The port's CUDA kernels (exact and banded top-k, the full Hamming
similarity of clustering, the Eq. 1 encoder, the analog PCM MVM and the
int8-KV decode attention) against their plain PyTorch versions, the
clustering path around the Hamming kernel, the tuner's launch knobs, LM
decoding through the attention kernel, the analog PCM model and the
end-to-end pipelines on the ``imc_mvm`` kernel, the recurrent layers and
models (xLSTM, Hymba) and the encoder-decoder and VLM decode (Whisper,
InternVL2) against the CPU, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). Run on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: exact, except decode attention (float32 softmax and dots
summed in another order: rtol / atol 2e-4). Indices, scores, similarities, HVs and labels are
integers, distances integers or halves, and the order (score desc, row
asc) is total; ``imc_mvm`` and its plain version round every float32
step alike, so they agree bit for bit too.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core.hd.clustering import (
    complete_linkage,
    pairwise_distances,
)
from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.core.hd.similarity import INT32_MIN
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_banded,
    encode_search_banded_plain,
    encode_search_plain,
)
from repro_torch.kernels.hamming_pop import hamming_pop, hamming_pop_plain
from repro_torch.kernels.topk_hamming import (
    topk_hamming,
    topk_hamming_banded,
    topk_hamming_banded_plain,
    topk_hamming_plain,
)

from repro_torch.kernels.hd_encode import hd_encode, hd_encode_plain
from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
from repro_torch.serve import ClusteringConfig, StreamingClusterer
from repro_torch.tune import sweep as tune_sweep
from repro_torch.tune import table as tune_table

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


# the exact scan's edge cases: (Q, R, D, k, num_valid, duplicates, plan);
# plan None takes the wrapper's launch plan, (block_q, None) the wrapper's
# plan for that query block (16 and 32 score on the tensor cores, 8 on the
# POPC scan), else (queries a block, rows a split) is launched as given.
# Packed banks; D % 32 != 0 holds random words, padding bits included
# (topk_hamming only)
SCAN_CASES = [
    (5, 1000, 256, 7, 600, False, None),    # ragged Q; num_valid in a tile
    (5, 1000, 256, 7, 600, False, (16, None)),   # R off the 64- and 256-row
                                                 # steps, nv in a step
    (1, 1000, 8192, 4, 999, False, None),   # Q = 1
    (1, 1000, 8192, 4, 999, False, (16, None)),  # Q = 1 in a 16-query block
    (4, 777, 256, 5, None, False, None),    # Q = 4: an 8-query block
    (33, 700, 256, 6, 650, False, None),    # two query blocks
    (16, 3000, 256, 5, 2900, False, (16, 100)),  # splits end inside a
                                                 # warpgroup's rows
    (32, 1500, 256, 4, 1234, True, (32, 320)),   # between warpgroups; ties
    (17, 300, 96, 9, None, True, (32, 37)),      # ties across warpgroups
    (7, 300, 20, 6, None, False, None),     # W = 1, dim 20
    (7, 300, 20, 6, None, False, (16, None)),    # the same, tensor cores
    (9, 500, 70, 5, None, True, None),      # W = 3, dim 70, ties
    (12, 400, 2070, 4, 333, False, None),   # W = 65, dim 2070
    (8, 300, 64, 300, None, False, (8, 64)),     # k = R over 5 splits
    (16, 300, 64, 300, None, False, (16, 64)),   # the same, tensor cores
]


def _scan_operands(rng, Q, R, D, dup):
    if D % 32 == 0:
        return _bank(rng, Q, D, True), _bank(rng, R, D, True, dup)
    W = -(-D // 32)
    words = rng.integers(0, 2**32, (Q + R, W), dtype=np.uint32).view(np.int32)
    q, r = torch.from_numpy(words[:Q]), torch.from_numpy(words[Q:])
    return q, torch.cat([r, r, r]) if dup else r


@pytest.mark.parametrize("Q,R,D,k,nv,dup,plan", SCAN_CASES)
def test_exact_scan_edge_cases_match_plain(cuda, Q, R, D, k, nv, dup, plan):
    from repro_torch.kernels.encode_search.ops import _launch_encode_search
    from repro_torch.kernels.topk_hamming.ops import _launch_exact
    rng = np.random.default_rng(Q * 1000 + R + D)
    q, bank = _scan_operands(rng, Q, R // 3 if dup else R, D, dup)
    q, bank = q.to(cuda), bank.to(cuda)
    bq, rows = plan or (None, None)
    got = (topk_hamming(q, bank, dim=D, k=k, num_valid=nv, block_q=bq)
           if rows is None else _launch_exact(q, bank, dim=D, k=k,
                                              num_valid=nv, bq=bq,
                                              rows_per_split=rows))
    want = topk_hamming_plain(q, bank, dim=D, k=k, num_valid=nv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if D % 32:
        return
    F, m = 300, 16
    id_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(F, D)).astype(np.int8)).to(cuda)
    lv_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(m, D)).astype(np.int8)).to(cuda)
    levels = rng.integers(0, m, size=(Q, F))
    levels[:, rng.random(F) < 0.7] = 0
    levels[-1, :3] = m + 2
    levels = torch.from_numpy(levels.astype(np.int32)).to(cuda)
    got = (encode_search(levels, id_hvs, lv_hvs, bank, dim=D, k=k,
                         num_valid=nv, block_q=bq) if rows is None
           else _launch_encode_search(levels, id_hvs, lv_hvs, bank, dim=D,
                                      k=k, num_valid=nv, codebook_words=None,
                                      bq=bq, rows_per_split=rows))
    want = encode_search_plain(levels, id_hvs, lv_hvs, bank, dim=D, k=k,
                               num_valid=nv)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("Q,F,D,packed", [(1, 300, 256, True),
                                          (32, 1024, 8192, True),
                                          (5, 3000, 4096, True),
                                          (9, 300, 1000, False),
                                          (4, 70, 13, False),
                                          (3, 5000, 256, True),
                                          (4, 37, 72, False)])
def test_encode_kernel_matches_plain(cuda, Q, F, D, packed):
    from repro_torch.kernels.encode_search.ops import (
        encode_queries,
        encode_queries_plain,
    )
    rng = np.random.default_rng(Q + F + D)
    m = 16
    id_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(F, D)).astype(np.int8)).to(cuda)
    lv_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(m, D)).astype(np.int8)).to(cuda)
    levels = rng.integers(0, m + 3, size=(Q, F))   # levels past m - 1 too
    levels[:, rng.random(F) < 0.5] = 0
    levels = torch.from_numpy(levels.astype(np.int32)).to(cuda)
    bank = _bank(rng, 3, D, packed).to(cuda)
    got = encode_queries(levels, id_hvs, lv_hvs, bank)
    want = encode_queries_plain(levels, id_hvs, lv_hvs, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("packed", [True, False])
def test_encode_kernel_with_no_present_feature_matches_plain(cuda, packed):
    """All-zero levels: every dim's sum is 0, signed -1."""
    from repro_torch.kernels.encode_search.ops import (
        encode_queries,
        encode_queries_plain,
    )
    rng = np.random.default_rng(11)
    F, D, m = 300, 256, 16
    id_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(F, D)).astype(np.int8)).to(cuda)
    lv_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(m, D)).astype(np.int8)).to(cuda)
    levels = torch.zeros((6, F), dtype=torch.int32, device=cuda)
    bank = _bank(rng, 3, D, packed).to(cuda)
    got = encode_queries(levels, id_hvs, lv_hvs, bank)
    want = encode_queries_plain(levels, id_hvs, lv_hvs, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    elif kind == "empty":      # every band empty
        starts, lens = rng.integers(0, R, Q), np.zeros(Q, np.int64)
    elif kind == "whole":      # query 0's band is the whole bank
        starts, lens = rng.integers(0, R // 2, Q), rng.integers(0, R // 4, Q)
        starts[0], lens[0] = 0, R
    elif kind == "one_row":    # bands meeting a 32-row tile in one row (the
        t = rng.integers(1, R // 32 - 1, Q) * 32   # window starts at row 0)
        starts = np.where(np.arange(Q) % 2 == 0, t - 1, t + 31)
        lens = np.where(np.arange(Q) % 3 == 0, 1, 2)
        starts[0], lens[0] = 0, 1
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
    (1, 3000, 256, True, 4, None, False, "wide", None),   # Q = 1
    (7, 2000, 256, True, 1, None, False, "random", None),  # Q = 7, k = 1
    (33, 3000, 256, True, 5, 2500, False, "wide", None),  # two query groups;
                                                          # num_valid in bands
    (70, 4000, 256, True, 4, None, False, "two", None),   # three groups
    (40, 3000, 8192, False, 4, None, False, "two", None),  # int8 rows of 8 KB:
                                                           # 8 stages a tile,
                                                           # 16 queries a group
    (12, 300, 64, True, 4, None, False, "empty", None),   # every band empty
    (9, 1500, 256, True, 6, None, False, "whole", 2),     # one band = bank
    (16, 500, 1000, False, 8, None, False, "one_row", None),  # int8; bands
                                                              # meeting a tile
                                                              # in one row
    (3, 4000, 256, True, 3632, None, False, "wide", None),  # the largest k
                                                            # the split merge
                                                            # takes
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


def test_encode_search_banded_with_empty_split_windows_matches_plain(cuda):
    """Every query's first band lies within 230 rows, under a 16-tile
    budget (most blocks of the group meet no live tile and write only
    fillers), and the second band is empty for the first 8 queries."""
    rng = np.random.default_rng(41)
    Q, R, D, F, m, k = 24, 4000, 256, 300, 16, 5
    id_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(F, D)).astype(np.int8)).to(cuda)
    lv_hvs = torch.from_numpy(
        rng.choice([-1, 1], size=(m, D)).astype(np.int8)).to(cuda)
    levels = rng.integers(0, m, size=(Q, F))
    levels[:, rng.random(F) < 0.7] = 0
    levels = torch.from_numpy(levels.astype(np.int32)).to(cuda)
    bank = _bank(rng, R, D, True).to(cuda)
    s0 = 100 + 5 * np.arange(Q)
    s1 = 2500 + 3 * np.arange(Q)
    lens1 = np.where(np.arange(Q) < 8, 0, rng.integers(0, 8, Q))
    starts = torch.from_numpy(np.stack([s0, s1]).astype(np.int32)).to(cuda)
    lens = torch.from_numpy(np.stack([rng.integers(1, 6, Q), lens1])
                            .astype(np.int32)).to(cuda)
    got = encode_search_banded(levels, id_hvs, lv_hvs, bank, starts, lens,
                               dim=D, k=k, num_tiles=16)
    want = encode_search_banded_plain(levels, id_hvs, lv_hvs, bank, starts,
                                      lens, dim=D, k=k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (Q, R, W, layout): ragged Q and R against the 64 x 64 tile, W = 1, 3
# and 64, W not a multiple of 4 (4-byte loads), rows off a 16-byte
# boundary, all-zero and all-ones words, q = r, and the served buckets
# against a grown centroid bank
HAMMING_CASES = [
    (1, 1, 1, "random"),
    (1, 1000, 64, "random"),
    (70, 130, 3, "random"),
    (65, 64, 64, "random"),
    (33, 200, 2, "random"),
    (40, 77, 64, "offset"),        # 4-byte aligned rows: 4-byte loads
    (5, 300, 64, "zeros_ones"),
    (500, 500, 64, "same"),
    (4, 1000, 64, "random"),
    (8, 3000, 64, "random"),
    (16, 3000, 64, "random"),
    (32, 3000, 64, "random"),
]


@pytest.mark.parametrize("Q,R,W,layout", HAMMING_CASES)
def test_hamming_pop_kernel_matches_plain(cuda, Q, R, W, layout):
    g = torch.Generator().manual_seed(Q * 1000 + R + W)

    def words(rows):
        if layout == "offset":   # one word past a 16-byte boundary
            flat = torch.randint(-2**31, 2**31, (rows * W + 1,),
                                 generator=g, dtype=torch.int64)
            return flat.to(torch.int32).to(cuda)[1:].view(rows, W)
        return torch.randint(-2**31, 2**31, (rows, W), generator=g,
                             dtype=torch.int64).to(torch.int32).to(cuda)

    q, r = words(Q), words(R)
    if layout == "zeros_ones":
        q, r = torch.zeros_like(q), torch.full_like(r, -1)
    elif layout == "same":
        r = q
    before = hamming_pop.launches
    got = hamming_pop(q, r, dim=32 * W)
    want = hamming_pop_plain(q, r, dim=32 * W)
    torch.cuda.synchronize()
    assert hamming_pop.launches == before + 1
    assert torch.equal(got, want)


def test_min_argmin_argmax_take_the_first_index_on_ties_on_the_card(cuda):
    x = torch.full((100_003,), 5.0, device=cuda)
    x[[17, 50_000, 100_002]] = 1.0
    assert int(torch.argmin(x)) == 17
    m = x.repeat(3, 1)
    m[1, 3] = 1.0
    vals, idx = m.min(dim=1)
    assert idx.tolist() == [17, 3, 17]
    v = torch.zeros((2, 5000), dtype=torch.int32, device=cuda)
    v[:, [9, 4000]] = 7
    assert torch.argmax(v, dim=-1).tolist() == [9, 9]


def test_linkage_over_kernel_distances_matches_plain(cuda):
    rng = np.random.default_rng(0)
    protos = rng.choice([-1, 1], size=(40, 2048)).astype(np.int8)
    hv = np.repeat(protos, 6, axis=0)
    flip = rng.random(hv.shape) < 0.15
    hv[flip] = -hv[flip]
    words = bitpack_bipolar(torch.from_numpy(hv).to(cuda))
    got = complete_linkage(pairwise_distances(words, dim=2048), 737.0)
    want = complete_linkage(pairwise_distances(
        words, dim=2048, hamming=hamming_pop_plain), 737.0)
    on_cpu = complete_linkage(pairwise_distances(words.cpu(), dim=2048),
                              737.0)
    assert torch.equal(got.labels, want.labels)
    assert torch.equal(got.labels.cpu(), on_cpu.labels)
    assert got.num_merges == want.num_merges == on_cpu.num_merges > 0


def test_streaming_clusterer_on_the_card_matches_its_plain_replay(cuda):
    rng = np.random.default_rng(1)
    protos = rng.choice([-1, 1], size=(30, 2048)).astype(np.int8)
    hv = np.repeat(protos, 8, axis=0)[rng.permutation(240)]
    flip = rng.random(hv.shape) < 0.12
    hv[flip] = -hv[flip]
    cfg = ClusteringConfig(dim=2048, threshold=737.0, consolidate_every=64)
    out = []
    for hamming in (None, hamming_pop_plain):
        cl = StreamingClusterer(cfg, cuda, hamming=hamming)
        got = []
        for i in range(0, len(hv), 32):
            c0, sv = cl.num_clusters, cl.struct_version
            d = cl.snapshot_distances(hv[i:i + 32])
            got += cl.assign_batch(hv[i:i + 32],
                                   None if d is None else d.cpu().numpy(),
                                   c0, sv)
        out.append(([(a.cluster_id, a.spawned, a.distance) for a in got],
                    cl.summary()))
    assert out[0] == out[1]


# (B, F, D, m, layout, block_b, block_d): ragged B, F and D, all-absent
# rows, sign ties, levels past m - 1, and several launch shapes
HD_ENCODE_CASES = [
    (32, 1024, 8192, 16, "sparse", None, None),
    (5, 37, 100, 8, "past_m", None, None),
    (13, 300, 1000, 16, "sparse", 4, 256),
    (9, 64, 96, 4, "absent", 2, 32),
    (7, 2, 64, 4, "ties", 1, 8192),
    (33, 128, 8192, 16, "sparse", 3, 1024),
    (6, 33, 72, 4, "none", None, None),      # no present feature; D % 16 = 8
    (4, 5000, 8192, 16, "dense", None, None),  # 5 compaction rounds of 1,024
    (3, 4100, 20000, 8, "dense", 2, 16384),  # 2 rounds of 4,096, two word
                                             # passes, levels past m - 1
]


def _hd_operands(rng, B, F, D, m, layout):
    idh = rng.choice([-1, 1], size=(F, D)).astype(np.int8)
    lvh = rng.choice([-1, 1], size=(m, D)).astype(np.int8)
    lev = rng.integers(0, m, size=(B, F))
    if layout == "sparse":
        lev[:, rng.random(F) < 0.9] = 0
    elif layout == "past_m":
        lev[:, :5] = m + 2
    elif layout == "absent":
        lev[::2] = 0
    elif layout == "ties":           # two present bins: acc in {-2, 0, 2}
        lev = rng.integers(1, m, size=(B, F))
    elif layout == "none":
        lev[:] = 0
    elif layout == "dense":          # every bin present, some past m - 1
        lev = rng.integers(1, m + 3, size=(B, F))
    return (torch.from_numpy(lev.astype(np.int32)), torch.from_numpy(idh),
            torch.from_numpy(lvh))


@pytest.mark.parametrize("B,F,D,m,layout,bb,bd", HD_ENCODE_CASES)
def test_hd_encode_kernel_matches_plain(cuda, B, F, D, m, layout, bb, bd):
    rng = np.random.default_rng(B * 1000 + F + D)
    lev, idh, lvh = (t.to(cuda) for t in _hd_operands(rng, B, F, D, m,
                                                       layout))
    before = hd_encode.launches
    got = hd_encode(lev, idh, lvh, block_b=bb, block_d=bd)
    want = hd_encode_plain(lev, idh, lvh)
    torch.cuda.synchronize()
    assert hd_encode.launches == before + 1
    assert torch.equal(got, want)
    if layout in ("absent", "none"):
        assert bool((got[::2] == -1).all())


# (Q, R, Dp, weights, full_scale, tile_cols, block_q, block_r): integer
# and float weights, exact .5 points of part / lsb (lsb = 2), saturation,
# ragged Q, R and Dp, another array width, and every compiled tile shape
IMC_CASES = [
    (32, 4000, 2731, "noisy", 135.7645, 128, None, None),
    (9, 70, 300, "integer", 135.76, 128, 8, 32),
    (17, 300, 257, "integer", 62.0, 128, 16, 64),       # .5 points
    (8, 129, 128, "saturate", 31.0, 128, 32, 128),
    (40, 515, 1000, "normal", 128.0, 64, 64, 256),
    (3, 33, 5, "normal", 10.0, 128, 32, 32),
]


def _imc_operands(rng, Q, R, Dp, kind):
    if kind in ("integer", "saturate"):
        q = rng.integers(-4, 5, size=(Q, Dp)).astype(np.float32)
        w = rng.integers(-3, 4, size=(R, Dp)).astype(np.float32)
        if kind == "saturate":
            w = np.sign(q[:1]) * 3 + 0 * w
    elif kind == "noisy":
        q = (2 * rng.binomial(3, 0.5, size=(Q, Dp)) - 3).astype(np.float32)
        w = (2 * rng.binomial(3, 0.5, size=(R, Dp)) - 3) * (
            1 + 0.1716 * rng.standard_normal((R, Dp)))
    else:
        q = rng.standard_normal((Q, Dp)) * 2
        w = rng.standard_normal((R, Dp))
    return (torch.from_numpy(np.ascontiguousarray(q, np.float32)),
            torch.from_numpy(np.ascontiguousarray(w, np.float32)))


@pytest.mark.parametrize("Q,R,Dp,kind,fs,tc,bq,br", IMC_CASES)
def test_imc_mvm_kernel_matches_plain(cuda, Q, R, Dp, kind, fs, tc, bq, br):
    rng = np.random.default_rng(Q * 1000 + R + Dp)
    q, w = (t.to(cuda) for t in _imc_operands(rng, Q, R, Dp, kind))
    before = imc_mvm.launches
    got = imc_mvm(q, w, full_scale=fs, tile_cols=tc, block_q=bq,
                  block_r=br)
    want = imc_mvm_plain(q, w, full_scale=fs, tile_cols=tc)
    torch.cuda.synchronize()
    assert imc_mvm.launches == before + 1
    assert torch.equal(got, want)
    if kind == "saturate":   # every tile's code sits at +-31
        assert float(got.abs().max()) > 0


# edge cases of the fused-partial kernel: (Q, R, Dp, full_scale, adc_levels,
# layout): the double-rounding partial (-2**-60 from a cancellation, then
# 3 * (1 + 2**-23), with lsb = 2**-22 so each float32 ulp of a partial is
# its own code), float weights at Dp = 2,731 (rows off 16-byte boundaries)
# with R % 4 = 1, 2 and 3 and R < 4, one ragged 43-column tile, and
# Q = 1 and 33
IMC_EDGE_CASES = [
    (4, 300, 300, 4.0, 2 ** 24, "fma_tie"),
    (32, 1001, 2731, 135.7645, 31, "noisy"),
    (32, 1002, 2731, 135.7645, 31, "noisy"),
    (32, 1003, 2731, 135.7645, 31, "noisy"),
    (5, 3, 300, 135.7645, 31, "noisy"),
    (32, 700, 43, 135.7645, 31, "noisy"),
    (1, 500, 300, 135.7645, 31, "noisy"),
    (33, 300, 2731, 135.7645, 31, "noisy"),
]


@pytest.mark.parametrize("Q,R,Dp,fs,adc,kind", IMC_EDGE_CASES)
def test_imc_mvm_edge_cases_match_plain(cuda, Q, R, Dp, fs, adc, kind):
    rng = np.random.default_rng(Q * 1000 + R + Dp)
    q, w = _imc_operands(rng, Q, R, Dp, "noisy")
    if kind == "fma_tie":   # columns 0-2 of each tile, even rows
        w[::2] = 0
        for c0 in range(0, Dp - 2, 128):
            q[:, c0:c0 + 3] = torch.tensor([1.0, -1.0, 3.0])
            w[::2, c0:c0 + 3] = torch.tensor(
                [2.0 ** -37, 2.0 ** -37 * (1 + 2.0 ** -23), 1 + 2.0 ** -23])
    q, w = q.to(cuda), w.to(cuda)
    got = imc_mvm(q, w, full_scale=fs, adc_levels=adc)
    want = imc_mvm_plain(q, w, full_scale=fs, adc_levels=adc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if kind == "fma_tie":   # three tiles of 3 + 2**-22, accumulated by FMA
        assert float(got[0, 0]) == float(np.float32(
            np.float32(np.float32(3 + 2.0 ** -22) * 2) + (3 + 2.0 ** -22)))


def test_imc_mvm_rejects_weights_off_a_16_byte_boundary(cuda):
    q = torch.zeros((2, 8), device=cuda)
    w = torch.zeros(3 * 8 + 1, device=cuda)[1:].view(3, 8)
    with pytest.raises(ValueError, match="16-byte"):
        imc_mvm(q, w, full_scale=10.0)


# hamming_pop edge cases of the tensor-core kernel: (Q, R, W, dim offset,
# layout): Q or R under one 16 x 8 fragment, W = 1, 3, 65 and 130 (off
# every 8-word chunk), dim < 32 W with random padding bits, and q = r at
# a pairwise shape over many blocks
HAMMING_EDGE_CASES = [
    (3, 5, 64, 0, "random"), (50, 6, 65, 0, "random"),
    (40, 300, 65, 0, "random"), (129, 90, 130, 0, "offset"),
    (2, 2, 1, 0, "random"), (31, 33, 3, 0, "random"),
    (33, 200, 64, 13, "random"), (130, 129, 3, 13, "random"),
    (2048, 2048, 64, 0, "same"),
]


@pytest.mark.parametrize("Q,R,W,short,layout", HAMMING_EDGE_CASES)
def test_hamming_pop_edge_cases_match_plain(cuda, Q, R, W, short, layout):
    g = torch.Generator().manual_seed(Q * 1000 + R + W + short)

    def words(rows):
        flat = torch.randint(-2**31, 2**31, (rows * W + 1,), generator=g,
                             dtype=torch.int64).to(torch.int32).to(cuda)
        return (flat[1:] if layout == "offset" else flat[:-1]).view(rows, W)

    q = words(Q)
    r = q if layout == "same" else words(R)
    dim = 32 * W - short
    got = hamming_pop(q, r, dim=dim)
    want = hamming_pop_plain(q, r, dim=dim)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", tune_sweep.OPS)
def test_every_quick_candidate_is_bit_identical_to_the_default(cuda, op):
    shape, run = tune_sweep._workload(op, True, cuda)
    want = run(tune_sweep.DEFAULTS[op])
    for cand in tune_sweep._candidates(op, True):
        assert tune_sweep._same_result(want, run(cand)), cand


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_served_fused_batch_is_the_same_with_a_table_active(cuda, shards):
    from repro_torch.serve import search_database_encoded, shard_database
    rng = np.random.default_rng(shards)
    refs = torch.from_numpy(rng.choice([-1, 1], size=(3000, 8192)).astype(
        np.int8)).to(cuda)
    queries = bitpack_bipolar(torch.from_numpy(rng.choice(
        [-1, 1], size=(32, 8192)).astype(np.int8)).to(cuda))
    db = shard_database(refs, emulate_shards=shards, fused=True)
    tune_table.reset()
    try:
        before = topk_hamming.launches
        idx0, val0 = search_database_encoded(db, queries, 4)
        table = tune_table.TuningTable(
            device_kind=tune_table.device_kind(cuda))
        table.set_entry("topk_hamming", (32, db.shard_rows, 256),
                        {"block_q": 8, "waves": 1})
        tune_table.set_active_table(table)
        assert tune_table.lookup_blocks("topk_hamming",
                                        (32, db.shard_rows, 256), cuda)
        idx1, val1 = search_database_encoded(db, queries, 4)
        torch.cuda.synchronize()
    finally:
        tune_table.reset()
    assert topk_hamming.launches == before + 2 * shards
    assert torch.equal(idx0, idx1) and torch.equal(val0, val1)


def test_burst_seconds_hides_the_hosts_issue_time(cuda):
    from repro_torch.tune.microbench import burst_seconds
    lev, idh, lvh, words = tune_sweep.encoder_operands(True, cuda)

    def call():
        hd_encode(lev, idh, lvh, codebook_words=words)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_s = (time.perf_counter() - t0) / 50
    torch.cuda.synchronize()
    samples = burst_seconds(call, cuda, calls=50, iters=3)
    assert len(samples) == 3 and all(t > 0 for t in samples)
    # a quick-shape encode is launch-bound: the device time per call is
    # below what the host takes to issue it
    assert sorted(samples)[1] < host_s


# decode_attention cases: (B, S, KV, G, hd, valid lengths); the reference's
# test shapes, G = 1 at hd = 256 (gemma), granite's G = 48, llama4's G = 5
# at hd 128, valid_len 1 / 70 / S,
# S off every chunk multiple, valid_len 0 and the served shape; then the
# split rule's edges on an H100's 132 SMs: valid_len at a split boundary
# - 1 / + 0 / + 1 (8 splits of 125; the served 3 of 363), valid_len 1 with
# every later split empty, and S under one split; hd 48 and 96 (rows of 3
# and 6 16-byte segments). Tolerance: rtol / atol 2e-4 (float32; the
# reference's kernel-vs-oracle tolerance).
DECODE_CASES = [
    (1, 128, 1, 4, 32, (128,)), (2, 256, 2, 8, 64, (256, 77)),
    (2, 96, 4, 7, 16, (96,)), (2, 300, 2, 1, 256, (300, 129)),
    (1, 200, 1, 48, 128, (200, 64)), (1, 128, 2, 4, 32, (1, 70, 128)),
    (3, 333, 2, 3, 64, (333, 65, 0)), (32, 1088, 4, 7, 128, (1025, 1088)),
    (2, 1000, 2, 7, 128, (124, 125, 126, 1, 0, 1000)),
    (32, 1088, 4, 7, 128, (362, 363, 364, 1)),
    (4, 100, 2, 7, 128, (1, 99, 100, 0)),
    (2, 150, 2, 5, 48, (150, 77)), (1, 100, 1, 12, 96, (100, 33)),
    (4, 600, 8, 5, 128, (600, 513, 1)),     # llama4's G = 5 at hd 128
    # Whisper's G = 1 at hd 64 and InternVL2's G = 8 at hd 128, served
    # (S = 528: one split) and at 5 splits of 106 (valid_len 105-107)
    (32, 528, 16, 1, 64, (257, 271, 528)),
    (2, 528, 16, 1, 64, (105, 106, 107, 1)),
    (32, 528, 8, 8, 128, (513, 527, 528)),
    (4, 528, 8, 8, 128, (105, 106, 107, 1)),
]


def _decode_operands(cuda, B, S, KV, G, hd, seed=0):
    rng = np.random.default_rng(seed + B * S + G * hd)
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32) * hd ** -0.5
    k8 = rng.integers(-127, 128, (B, S, KV, hd), dtype=np.int8)
    v8 = rng.integers(-127, 128, (B, S, KV, hd), dtype=np.int8)
    ks = rng.uniform(0.005, 0.5, (B, S, KV)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, S, KV)).astype(np.float32)
    return [torch.from_numpy(a).to(cuda) for a in (q, k8, v8, ks, vs)]


@pytest.mark.parametrize("B,S,KV,G,hd,valid", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(cuda, B, S, KV, G, hd, valid):
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    ops = _decode_operands(cuda, B, S, KV, G, hd)
    for vl in valid:
        before = decode_attention.launches
        got = decode_attention(*ops, vl)
        want = decode_attention_plain(*ops, vl)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("splits", [1, 2, 7, 17])
def test_decode_attention_forced_splits_match_plain(cuda, splits):
    """S = 300 cut into each split count; valid_len around the first
    split boundary, 0 and S."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.decode_attention.ops import _launch, split_plan
    ops = _decode_operands(cuda, 2, 300, 2, 7, 128, seed=splits)
    n, per = split_plan(300, splits)
    assert n == splits
    for vl in (0, 1, per - 1, per, per + 1, 300):
        got = _launch(*ops, vl, splits)
        want = decode_attention_plain(*ops, vl)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_decode_attention_is_one_launch_per_call_with_no_host_sync(cuda):
    """The splits merge inside the launch: one kernel per call on the
    device, the count up by one, and no host synchronization."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    ops = _decode_operands(cuda, 4, 1000, 2, 7, 128)
    decode_attention(*ops, 500)      # makes this stream's merge counters
    torch.cuda.synchronize()
    before = decode_attention.launches
    valid = (1, 500, 1000)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [decode_attention(*ops, vl) for vl in valid]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert decode_attention.launches == before + len(valid)
    kernels = [e.key for e in prof.key_averages()
               for _ in range(e.count)
               if (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))]
    assert len(kernels) == len(valid)
    assert all("decode_attention_kernel" in k for k in kernels)
    for vl, got in zip(valid, outs):
        torch.testing.assert_close(got, decode_attention_plain(*ops, vl),
                                   rtol=2e-4, atol=2e-4)


def test_decode_attention_masked_tail_is_bit_identical(cuda):
    from repro_torch.kernels.decode_attention import decode_attention
    q, k8, v8, ks, vs = _decode_operands(cuda, 2, 200, 2, 7, 128, seed=5)
    out = decode_attention(q, k8, v8, ks, vs, 70)
    k8b, v8b = k8.clone(), v8.clone()
    k8b[:, 70:] = 127
    v8b[:, 70:] = 127
    assert torch.equal(decode_attention(q, k8b, v8b, ks, vs, 70), out)


# decode_attention_partial cases: (B, S, KV, G, hd, valid lengths): a
# rank's block of granite_20b's cache striped over 2 and 4 ranks (8 rows,
# 1,032 and 516 slots, 1 kv head, G = 48), the served Qwen2-7B shape at
# its split boundary, hd 48 and 256; valid_len 0 (an empty block: out 0,
# lse -inf), 1, mid-block and at and past S. Tolerance as decode_attention.
PARTIAL_CASES = [
    (8, 1032, 1, 48, 128, (0, 1, 517, 1032, 5000)),
    (8, 516, 1, 48, 128, (0, 258, 516, 517)),
    (32, 1088, 4, 7, 128, (0, 362, 363, 364, 1088)),
    (2, 300, 2, 5, 48, (1, 150, 300, 301)),
    (1, 64, 1, 1, 256, (0, 64)),
]


def _partial_matches_plain(got, want, vl):
    out, lse = got
    if vl <= 0:
        assert bool((out == 0).all()) and bool((lse == float("-inf")).all())
        return
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    torch.testing.assert_close(out, want[0], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lse, want[1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,S,KV,G,hd,valid", PARTIAL_CASES)
def test_decode_attention_partial_kernel_matches_plain(cuda, B, S, KV, G, hd,
                                                       valid):
    """The output and the log-sum-exp, one launch a call."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_partial,
        decode_attention_partial_plain,
    )
    ops = _decode_operands(cuda, B, S, KV, G, hd)
    for vl in valid:
        before = decode_attention.launches
        got = decode_attention_partial(*ops, vl)
        want = decode_attention_partial_plain(*ops, vl)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        assert got[0].shape == ops[0].shape and got[1].shape == (B, KV, G)
        _partial_matches_plain(got, want, vl)


@pytest.mark.parametrize("splits", [1, 2, 7, 17])
def test_decode_attention_partial_forced_splits_match_plain(cuda, splits):
    """S = 300 cut into each split count: valid_len 0, 1 (every later
    split empty) and around the first boundary."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_partial_plain,
    )
    from repro_torch.kernels.decode_attention.ops import _launch, split_plan
    ops = _decode_operands(cuda, 2, 300, 2, 7, 128, seed=splits)
    _, per = split_plan(300, splits)
    for vl in (0, 1, per - 1, per, per + 1, 300):
        got = _launch(*ops, vl, splits, partial=True)
        want = decode_attention_partial_plain(*ops, vl)
        torch.cuda.synchronize()
        _partial_matches_plain(got, want, vl)


@pytest.mark.parametrize("edges", [(0, 516, 1032), (0, 258, 516, 774, 1032)])
def test_decode_attention_partial_blocks_combine_on_the_card(cuda, edges):
    """granite_20b's 1,032 slots cut into 2 and 4 blocks, each on the
    partial kernel with its own count, combined (``layers.
    combine_partials``): ``decode_attention`` over the whole cache, with
    valid lengths that leave later blocks empty."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_partial,
    )
    from repro_torch.models import layers as L

    ops = _decode_operands(cuda, 8, 1032, 1, 48, 128, seed=11)

    def stacked(t, op):
        r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
        return r.expand_as(t).clone()

    for vl in (1, 300, 516, 517, 1032):
        parts = [decode_attention_partial(
            ops[0], *(t[:, s0:s1].contiguous() for t in ops[1:]),
            min(max(vl - s0, 0), s1 - s0))
            for s0, s1 in zip(edges[:-1], edges[1:])]
        got = L.combine_partials(torch.stack([p[0] for p in parts]),
                                 torch.stack([p[1] for p in parts]), stacked)
        want = decode_attention(*ops, vl)
        torch.cuda.synchronize()
        for r in range(len(parts)):
            torch.testing.assert_close(got[r], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hd", [8, 24, 272])
def test_decode_attention_raises_on_unsupported_head_dim(cuda, hd):
    from repro_torch.kernels.decode_attention import decode_attention
    ops = _decode_operands(cuda, 1, 16, 1, 2, hd)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(*ops, 8)
    assert decode_attention.launches == before


def test_attention_decode_on_cuda_launches_the_kernel(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("qwen2_7b"), num_layers=1,
                              kv_quant_int8=True)
    p = L.init_attention(cfg, cuda,
                         torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn(4, 40, cfg.d_model, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    caches = [L.init_kv_cache(cfg, 4, 48, device=cuda) for _ in range(2)]
    for c in caches:
        L.attention_prefill(p, x[:, :32], cfg, c)
    before = decode_attention.launches
    calls = decode_attention_plain.calls
    for pos in range(32, 40):
        y_k, _ = L.attention_decode(p, x[:, pos:pos + 1], cfg, caches[0], pos)
        y_p, _ = L.attention_decode(p, x[:, pos:pos + 1], cfg, caches[1], pos,
                                    decode_attention_plain)
        torch.cuda.synchronize()
        # bf16 outputs of float32 attention outputs within 2e-4 of each
        # other: at most a rounding step of the bf16 result apart
        torch.testing.assert_close(y_k.float(), y_p.float(), rtol=1e-2,
                                   atol=1e-2)
    assert decode_attention.launches == before + 8
    assert decode_attention_plain.calls == calls + 8
    assert torch.equal(caches[0].k, caches[1].k)


def test_serve_launcher_reduced_kv_quant_on_cuda(cuda, capsys):
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.launch import serve
    calls = decode_attention_plain.calls
    run = serve.main(["--arch", "qwen2_7b", "--reduced", "--kv-quant",
                      "--batch", "4", "--prompt-len", "24", "--gen", "6"])
    out = capsys.readouterr().out
    assert run.launches == run.model.cfg.num_layers * 5
    assert decode_attention_plain.calls == calls
    assert run.tokens.shape == (4, 6) and run.tokens.is_cuda
    assert run.clock == "cuda events" and run.peak_bytes > 0
    assert "decode_attention launches: 10" in out


def test_decode_step_makes_no_host_sync(cuda):
    """The decode loop reads nothing back from the card: a decode step
    (int8 KV store, the kernel) runs under the sync debug mode "error"."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                              kv_quant_int8=True, dtype="bfloat16")
    model = build_model(cfg, cuda)
    params = model.init(seed=0)
    batch = TokenPipeline(2, 16, cfg.vocab_size).get(0, cuda)
    cache = model.init_cache(2, 20)
    logits, cache = model.prefill(params, batch, cache, last_only=True)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(params, tok, cache, 16)
        tok = logits.argmax(-1).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tok.shape == (2, 1)


# --------------------------------------------------------------------------
# continuous serving and streaming ingestion on the card
# --------------------------------------------------------------------------

GPU_D, GPU_BINS, GPU_LEVELS = 512, 64, 8


def _serving_fixture(cuda, seed=0, rows=600, held=40):
    """Library HVs (through the staged encode of random levels, so the
    fused-e2e routes see the same HVs), a held-out suffix to append, the
    encoder, query levels and HVs and precursors."""
    from repro_torch.core.hd.encoding import (
        HDEncoderConfig,
        encode_levels_batch,
        make_codebooks,
    )
    from repro_torch.serve import QueryEncoder
    rng = np.random.default_rng(seed)
    idh, lvh = make_codebooks(HDEncoderConfig(
        dim=GPU_D, num_features=GPU_BINS, num_levels=GPU_LEVELS, seed=seed),
        device=cuda)
    lev = rng.integers(0, GPU_LEVELS, size=(2 * rows, GPU_BINS)).astype(
        np.int32)
    lev[rng.random(lev.shape) < 0.6] = 0
    hv = encode_levels_batch(torch.from_numpy(lev).to(cuda), idh, lvh)
    prec = rng.uniform(400, 1600, rows).astype(np.float32)
    q_rows = rng.integers(0, rows, 70)
    q_lev = lev[q_rows].copy()
    q_lev[::3] = rng.integers(0, GPU_LEVELS, size=q_lev[::3].shape)
    q_hv = encode_levels_batch(torch.from_numpy(q_lev).to(cuda), idh,
                               lvh).cpu().numpy()
    q_prec = (prec[q_rows] + rng.choice([0.0, 80.0], 70)).astype(np.float32)
    return dict(refs=hv[:rows], decoys=hv[rows:], prec=prec, held=held,
                encoder=QueryEncoder(id_hvs=idh, level_hvs=lvh),
                q_lev=q_lev, q_hv=q_hv, q_prec=q_prec)


def _gpu_server(fx, route, *, continuous, append=False, full=False,
                **kw):
    from repro_torch.serve import BankRegistry, DBSearchServer, OMSConfig
    oms = route.startswith("oms")
    e2e = route.endswith("e2e")
    keep = len(fx["prec"]) - (0 if full else fx["held"])
    reg = BankRegistry(fused=True)
    reg.register("a", fx["refs"][:keep], decoys=fx["decoys"][:keep],
                 precursor=fx["prec"][:keep] if oms else None)
    srv = DBSearchServer(reg, k=4, fdr=0.5, max_batch_size=16, buckets=3,
                         flush_timeout_s=0.0, continuous=continuous,
                         num_slots=2, oms=OMSConfig() if oms else None,
                         encoder=fx["encoder"] if e2e else None,
                         fused_e2e=e2e, **kw)
    if append:
        srv.append("a", fx["refs"][keep:], fx["decoys"][keep:],
                   precursor=fx["prec"][keep:] if oms else None)
    return reg, srv


def _serve_all(srv, fx, route, lo=0, hi=70):
    e2e = route.endswith("e2e")
    qs = fx["q_lev"] if e2e else fx["q_hv"]
    rids = [srv.submit(qs[i], tenant="a",
                       precursor=float(fx["q_prec"][i])
                       if route.startswith("oms") else None)
            for i in range(lo, hi)]
    done = {r.rid: r.result for r in srv.run_until_drained()}
    return [done[r] for r in rids]


def _results(res):
    return [(tuple(r.indices), tuple(r.scores), bool(r.accept), int(r.match),
             bool(r.has_candidate)) for r in res]


@pytest.mark.parametrize("route", ["fused", "fused_e2e", "oms_fused",
                                   "oms_fused_e2e"])
def test_continuous_serving_equals_flush_sync_on_the_card(cuda, route):
    """Both queue modes on the card (kernels, pinned staging, events)
    serve bit-identical per-request results, without and with a delta."""
    fx = _serving_fixture(cuda)
    for append in (False, True):
        out = {}
        for continuous in (False, True):
            _, srv = _gpu_server(fx, route, continuous=continuous,
                                 append=append)
            out[continuous] = _results(_serve_all(srv, fx, route))
            assert srv.summary()["device_busy_s"] > 0
        assert out[False] == out[True], (route, append)


@pytest.mark.parametrize("route", ["fused", "oms_fused", "oms_fused_e2e"])
def test_merged_serving_on_the_card_matches_the_rebuilt_bank(cuda, route):
    """A delta streamed in: the merged route (base kernel + the int8 delta
    through the same kernel) serves what the rebuilt bank serves."""
    fx = _serving_fixture(cuda, seed=3)
    _, live = _gpu_server(fx, route, continuous=True, append=True)
    _, full = _gpu_server(fx, route, continuous=True, full=True)
    assert _results(_serve_all(live, fx, route)) == _results(
        _serve_all(full, fx, route))


@pytest.mark.parametrize("oms", [False, True], ids=["exact", "oms"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "int8"])
@pytest.mark.parametrize("rows", [1, 4, 300], ids=["one", "kd", "many"])
def test_merged_search_kernels_match_the_rebuilt_bank(cuda, rows, packed,
                                                      oms):
    """The merged searches on the card, the int8 delta through
    ``topk_hamming`` (exact) or ``topk_hamming_banded`` (OMS): one launch
    on the base and one on the delta, bit-identical to the rebuilt bank's
    plain route; deltas of 1 row, of k rows and of many."""
    from repro_torch.serve import (
        DeltaBank,
        OMSConfig,
        encode_queries,
        merged_oms_plan,
        merged_oms_search_encoded,
        merged_search_encoded,
        oms_search,
        search_database,
        shard_database,
    )
    rng = np.random.default_rng(rows + 2 * packed + 4 * oms)
    D, k = 512, 4
    refs0 = torch.from_numpy(_bank(rng, 900, D, False).numpy()).to(cuda)
    dec0 = torch.from_numpy(_bank(rng, 500, D, False).numpy()).to(cuda)
    refs1 = torch.from_numpy(_bank(rng, rows, D, False).numpy()).to(cuda)
    refs1[0] = refs0[5]  # a tie across the append boundary
    q = torch.from_numpy(_bank(rng, 32, D, False).numpy()).to(cuda)
    q[3] = refs1[0]
    prec0 = rng.uniform(400, 1600, 900).astype(np.float32)
    prec1 = rng.uniform(400, 1600, rows).astype(np.float32)
    qprec = np.sort(rng.uniform(420, 1650, 32).astype(np.float32))
    kw = dict(precursor=prec0, decoy_precursor=prec0[:500]) if oms else {}
    base = shard_database(refs0, decoys=dec0, pack=packed, fused=True, **kw)
    delta = DeltaBank(D, oms=oms, device=cuda)
    delta.append(refs1, precursor=prec1 if oms else None)
    rkw = dict(precursor=np.concatenate([prec0, prec1]),
               decoy_precursor=prec0[:500]) if oms else {}
    rebuilt = shard_database(torch.cat([refs0, refs1]), decoys=dec0,
                             pack=packed, **rkw)
    kern = topk_hamming_banded if oms else topk_hamming
    before = kern.launches
    q_enc = encode_queries(base, q)
    if oms:
        cfg = OMSConfig(tol=20.0, open_tol=200.0)
        mplan = merged_oms_plan(base, delta, qprec, cfg)
        got = merged_oms_search_encoded(base, delta, q_enc, q, mplan, k)
        want = oms_search(rebuilt, q, qprec, k, cfg)[:2]
    else:
        got = merged_search_encoded(base, delta, q_enc, q, k)
        want = search_database(rebuilt, q, k)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert torch.equal(got[0], want[0].to(got[0].dtype))
    assert torch.equal(got[1], want[1])


def test_compaction_swap_with_a_slot_in_flight_on_the_card(cuda):
    """A merged batch in flight while the registry compacts: it finishes
    on the bank and delta it was dispatched with, the next batch runs on
    the compacted bank, and both equal the rebuilt bank's results."""
    fx = _serving_fixture(cuda, seed=5)
    reg, srv = _gpu_server(fx, "fused", continuous=True, append=True)
    _, full = _gpu_server(fx, "fused", continuous=True, full=True)
    for i in range(16):
        srv.submit(fx["q_hv"][i], tenant="a")
    h = srv.executor.dispatch(srv.queue.take_batch())
    assert h.delta is not None
    assert reg.compact("a") and reg.delta("a") is None
    first = [r.result for r in srv.executor.finalize(h)]
    second = _serve_all(srv, fx, "fused", 16, 32)
    assert reg.get("a").num_rows == 2 * len(fx["prec"])
    assert _results(first + second) == _results(
        _serve_all(full, fx, "fused", 0, 32))


SYNC_FREE_ROUTES = ["encoded_misses", "fused_e2e", "oms", "oms_fused_e2e",
                    "merged_exact", "merged_oms", "merged_e2e", "cluster"]


@pytest.mark.parametrize("route", SYNC_FREE_ROUTES)
def test_each_route_dispatches_without_a_host_sync(cuda, route):
    """A dispatch never waits for the device: after one warm-up batch, a
    batch of fresh queries (cache misses) is dispatched under the sync
    debug mode "error", then finalized, and its results equal the flush-
    sync route's."""
    fx = _serving_fixture(cuda, seed=7)
    if route == "cluster":
        from repro_torch.serve import BankRegistry, DBSearchServer
        srv = DBSearchServer(BankRegistry(), max_batch_size=16, buckets=3,
                             flush_timeout_s=0.0, continuous=True,
                             clustering=ClusteringConfig(
                                 dim=GPU_D, threshold=0.36 * GPU_D),
                             cluster_device=cuda)
        submit = (lambda i: srv.submit_cluster(fx["q_hv"][i]))
    else:
        base = {"encoded_misses": "fused", "fused_e2e": "fused_e2e",
                "oms": "oms_fused", "oms_fused_e2e": "oms_fused_e2e",
                "merged_exact": "fused", "merged_oms": "oms_fused",
                "merged_e2e": "fused_e2e"}[route]
        _, srv = _gpu_server(fx, base, continuous=True,
                             append=route.startswith("merged"))
        qs = fx["q_lev"] if base.endswith("e2e") else fx["q_hv"]

        def submit(i):
            return srv.submit(qs[i], tenant="a",
                              precursor=float(fx["q_prec"][i])
                              if base.startswith("oms") else None)
    for i in range(16):
        submit(i)
    srv.run_until_drained()
    for i in range(16, 32):
        submit(i)
    reqs = srv.queue.take_batch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = srv.executor.dispatch(reqs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    live = srv.executor.finalize(h)
    assert len(live) == 16 and all(r.result is not None for r in live)


# --------------------------------------------------------------------------
# the analog PCM model and the end-to-end pipelines on the imc_mvm kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("Q,R,Dp,adc_bits,cols", [
    (32, 3000, 2731, 6, 128),   # a DB-search chunk's shape, cut in R
    (300, 300, 683, 6, 128),    # a clustering bucket's shape, cut
    (5, 77, 342, 4, 128), (9, 40, 300, 6, 64)])
def test_array_imc_mvm_on_cuda_matches_plain(cuda, Q, R, Dp, adc_bits, cols):
    from repro_torch.core.imc.array import (
        ArrayConfig,
        default_full_scale,
        imc_mvm as array_imc_mvm,
        program_hvs,
    )
    from repro_torch.core.imc.device import DeviceConfig

    g = torch.Generator(device=cuda).manual_seed(Q + R)
    hv = torch.randint(-3, 4, (R, Dp), generator=g, device=cuda,
                       dtype=torch.int8)
    q = torch.randint(-3, 4, (Q, Dp), generator=g, device=cuda,
                      dtype=torch.int8)
    cfg = ArrayConfig(adc_bits=adc_bits, cols=cols)
    state = program_hvs(g, hv, cfg, DeviceConfig("tite2", 3, 3))
    before, plain = imc_mvm.launches, imc_mvm_plain.calls
    got = array_imc_mvm(q, state)
    assert imc_mvm.launches == before + 1 and imc_mvm_plain.calls == plain
    want = imc_mvm_plain(q.float(), state.weights,
                         full_scale=default_full_scale(cfg), tile_cols=cols,
                         adc_levels=cfg.adc_levels)
    assert torch.equal(got, want)


def test_isa_mvm_compute_launches_the_kernel(cuda):
    from repro_torch.core.imc.array import imc_mvm as array_imc_mvm
    from repro_torch.core.imc.isa import ISAExecutor, compile_db_search
    from repro_torch.core.pipeline import SpecPCMConfig

    cfg = SpecPCMConfig(hd_dim=8193, mlc_bits=3, material="tite2",
                        write_verify=3)
    g = torch.Generator(device=cuda).manual_seed(0)
    bank = torch.randint(-3, 4, (5000, 2731), generator=g, device=cuda,
                         dtype=torch.int8)
    ex = ISAExecutor(cfg.array_cfg(), cfg.device_cfg(), seed=1, device=cuda)
    store, mvm = compile_db_search(5000, 2731, cfg.array_cfg(),
                                   cfg.write_verify, cfg.adc_bits,
                                   cfg.mlc_bits)
    ex.load_stage(bank)
    ex.execute_one(store)
    ex.load_stage(bank[:32])
    before, plain = imc_mvm.launches, imc_mvm_plain.calls
    ex.execute_one(mvm)
    assert imc_mvm.launches == before + 1 and imc_mvm_plain.calls == plain
    assert torch.equal(ex.result, array_imc_mvm(bank[:32], ex.state))
    assert ex.trace.instructions == 2


def _cpu_noise(monkeypatch):
    """Write noise drawn on the CPU and moved to the weights' device, so a
    run on the card and one on the CPU program the same weights."""
    from repro_torch.core import pipeline
    from repro_torch.core.imc.device import apply_write_noise

    calls = []

    def noise(generator, weights, cfg):
        calls.append(1)
        g = torch.Generator().manual_seed(len(calls))
        return apply_write_noise(g, weights.cpu(), cfg).to(weights.device)

    monkeypatch.setattr(pipeline, "apply_write_noise", noise)
    return calls


@pytest.mark.parametrize("ideal", [False, True])
def test_db_search_on_the_card_equals_the_cpu(cuda, ideal, monkeypatch):
    from repro_torch.core import SpecPCMConfig, run_db_search
    from repro_torch.spectra import (
        SyntheticMSConfig,
        generate_dataset,
        generate_query_set,
    )

    ms = SyntheticMSConfig(num_identities=300, spectra_per_identity=2,
                           num_bins=512, modification_mass_range=(60, 150))
    ds = generate_dataset(ms, device="cpu")
    q = generate_query_set(ds, ms, 600)
    cfg = SpecPCMConfig(hd_dim=2049, mlc_bits=3, num_levels=16,
                        material="tite2", write_verify=3, ideal=ideal)
    args = (q.spectra, q.precursor, ds.spectra, ds.precursor, cfg)
    kw = dict(query_identity=q.identity, ref_identity=ds.identity)
    calls = _cpu_noise(monkeypatch)
    want = run_db_search(*args, device="cpu", **kw)
    calls.clear()
    before, plain = imc_mvm.launches, imc_mvm_plain.calls
    got = run_db_search(*args, device=cuda, **kw)
    assert imc_mvm_plain.calls == plain
    assert imc_mvm.launches == before + (0 if ideal else 2)
    np.testing.assert_array_equal(got.matches, want.matches)
    np.testing.assert_array_equal(got.accepted, want.accepted)
    assert (got.num_identified, got.num_no_candidate, got.recall) == (
        want.num_identified, want.num_no_candidate, want.recall)
    assert got.cost == want.cost


@pytest.mark.parametrize("ideal", [False, True])
def test_clustering_on_the_card_equals_the_cpu(cuda, ideal, monkeypatch):
    from repro_torch.core import SpecPCMConfig, run_clustering
    from repro_torch.spectra import SyntheticMSConfig, generate_dataset

    ds = generate_dataset(SyntheticMSConfig(
        num_identities=60, spectra_per_identity=8, num_bins=512),
        device="cpu")
    cfg = SpecPCMConfig(hd_dim=2049, mlc_bits=3, num_levels=16, ideal=ideal)
    args = (ds.spectra, ds.precursor, ds.identity, cfg)
    calls = _cpu_noise(monkeypatch)
    want = run_clustering(*args, bucket_width=300.0, device="cpu")
    calls.clear()
    before, plain = imc_mvm.launches, imc_mvm_plain.calls
    got = run_clustering(*args, bucket_width=300.0, device=cuda)
    assert imc_mvm_plain.calls == plain
    assert (imc_mvm.launches > before) != ideal
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.clustered_ratio, got.incorrect_ratio, got.num_clusters) == (
        want.clustered_ratio, want.incorrect_ratio, want.num_clusters)
    assert got.cost == want.cost


# --------------------------------------------------------------------------
# training: the IMC-routed down-projection and a train step on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("f,lead", [(128, (2, 5)), (200, (3, 33)),
                                    (18_944, (1, 64)), (24_576, (1, 64))])
def test_imc_linear_kernel_matches_plain(cuda, f, lead, monkeypatch):
    """``_imc_linear`` on CUDA tensors launches ``imc_mvm`` once and equals,
    bit for bit, the same function with the plain version on the card;
    its gradient is the exact matmul's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                              imc_linear=True)
    rng = np.random.default_rng(f)
    x = torch.from_numpy(rng.normal(size=lead + (f,)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(f, 64)) * f ** -0.5)
                         .astype(np.float32))
    xc = x.to(cuda).requires_grad_()
    wc = w.to(cuda).requires_grad_()
    before, plain = imc_mvm.launches, imc_mvm_plain.calls
    got = L._imc_linear(xc, wc, cfg)
    assert imc_mvm.launches == before + 1 and imc_mvm_plain.calls == plain
    got.sum().backward()
    monkeypatch.setattr(L, "imc_mvm", imc_mvm_plain)
    with torch.no_grad():
        want = L._imc_linear(x.to(cuda), w.to(cuda), cfg)
    assert torch.equal(got.detach(), want)
    xe, we = x.to(cuda).requires_grad_(), w.to(cuda).requires_grad_()
    (xe @ we).sum().backward()
    assert torch.equal(xc.grad, xe.grad) and torch.equal(wc.grad, we.grad)


@pytest.mark.parametrize("imc", [False, True])
def test_train_step_on_the_card_matches_the_cpu(cuda, imc):
    """One ``make_train_step`` step of the reduced Qwen2 on the card
    against the same step on the CPU (float32, TF32 off): loss and
    grad_norm rtol 1e-5 / 1e-4, parameters within 2 lr (a gradient near
    0 or eps flips a whole AdamW update); with ``imc_linear`` the kernel
    launches once a layer (remat "full" stops its recompute before it)
    and the plain version never."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                              imc_linear=imc)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        state = init_train_state(build_model(cfg, "cpu"), seed=0)
        if dev != "cpu":
            state.params.to(dev)
            state.opt["mu"] = [t.to(dev) for t in state.opt["mu"]]
            state.opt["nu"] = [t.to(dev) for t in state.opt["nu"]]
        batch = TokenPipeline(8, 64, cfg.vocab_size).get_for(cfg, 0, dev)
        before, plain = imc_mvm.launches, imc_mvm_plain.calls
        state, m = make_train_step(model, tcfg)(state, batch)
        if dev != "cpu":
            assert imc_mvm.launches - before == (cfg.num_layers
                                                 if imc else 0)
            assert imc_mvm_plain.calls == plain
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in state.params.parameters()])
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=1e-4)
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 2e-3 + 1e-6


# --------------------------------------------------------------------------
# the MoE layer on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e"])
@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, arch, cf, monkeypatch):
    """``apply_moe`` (float32, TF32 off) on the card against the same call
    on the CPU: the routing (experts in ``lax.top_k``'s order, arrival
    positions, kept mask) equal, outputs within rtol / atol 1e-5. Eight
    all-zero rows tie every gate (the lower experts win); capacity
    factor 0.25 drops pairs (1.25 may too: the tied rows crowd experts 0
    and 1)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf)
    p = L.init_moe(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    x[1, :8] = 0.0
    seen = []
    route = L.moe_route

    def recording(*args):
        seen.append(route(*args))
        return seen[-1]

    monkeypatch.setattr(L, "moe_route", recording)
    want = L.apply_moe(p, x, cfg)
    got = L.apply_moe(p.to(cuda), x.to(cuda), cfg)
    cpu, card = seen
    for name in ("expert", "pos", "keep"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), \
            name
    if cf < 1:      # capacity 2 of 32 tokens a group: pairs are dropped
        assert bool((~cpu.keep).any())
    torch.testing.assert_close(card.weight.cpu(), cpu.weight, rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e"])
def test_moe_decode_step_makes_no_host_sync(cuda, arch):
    """An MoE decode step (bfloat16, int8 KV store, the decode kernel)
    runs under the sync debug mode "error": the routing, dispatch and
    combine read nothing back from the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              kv_quant_int8=True, dtype="bfloat16")
    model = build_model(cfg, cuda)
    params = model.init(seed=0)
    batch = TokenPipeline(4, 16, cfg.vocab_size).get(0, cuda)
    cache = model.init_cache(4, 20)
    logits, cache = model.prefill(params, batch, cache, last_only=True)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pos in (16, 17):
            logits, cache = model.decode_step(params, tok, cache, pos)
            tok = logits.argmax(-1).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tok.shape == (4, 1) and bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------------
# the recurrent families (xLSTM's mLSTM / sLSTM, Hymba's Mamba heads)
# --------------------------------------------------------------------------

def _close_to_scale(got, want, tol):
    """Within ``tol`` of the reference tensor's largest magnitude (at least
    1), elementwise."""
    want = want.detach().float().cpu()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.detach().float().cpu(), want, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("name", ["mamba", "mlstm", "slstm"])
def test_recurrent_layer_on_the_card_matches_the_cpu(cuda, name):
    """One recurrent layer (float32, TF32 off) on the card against the same
    calls on the CPU: the chunked forward over two chunks, eight decode
    steps with their states, and the state after the prompt; rtol and
    atol 1e-4 of each tensor's scale (cuBLAS and the CPU sum in other
    orders)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T

    assert not torch.backends.cuda.matmul.allow_tf32
    arch = "hymba_1_5b" if name == "mamba" else "xlstm_125m"
    cfg = dataclasses.replace(get_config(arch).reduced(), d_model=128)
    p = getattr(R, f"init_{name}")(cfg, generator=torch.Generator()
                                   .manual_seed(0))
    x = torch.randn(3, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pc, xc = copy.deepcopy(p).to(cuda), x.to(cuda)
    kw = {} if name == "slstm" else {"chunk": 16}
    train = getattr(R, f"{name}_train")
    _close_to_scale(train(pc, xc, cfg, **kw), train(p, x, cfg, **kw), 1e-4)
    after = getattr(T, f"_{name}_state_after")
    got_after, want_after = after(pc, xc, cfg), after(p, x, cfg)
    decode = getattr(R, f"{name}_decode")
    sc = getattr(R, f"init_{name}_state")(cfg, 3, cuda)
    s = getattr(R, f"init_{name}_state")(cfg, 3)
    for t in range(8):
        yc, sc = decode(pc, xc[:, t:t + 1], cfg, sc)
        y, s = decode(p, x[:, t:t + 1], cfg, s)
        _close_to_scale(yc, y, 1e-4)
    for f in dataclasses.fields(s):
        assert getattr(sc, f.name).is_cuda
        _close_to_scale(getattr(sc, f.name), getattr(s, f.name), 1e-4)
        _close_to_scale(getattr(got_after, f.name),
                        getattr(want_after, f.name), 1e-4)


def _hymba_g5(**kw):
    """Hymba's attention grouping (G = 5, hd = 64) at a small width, a
    16-position window and the int8 KV store, in bfloat16."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("hymba_1_5b").reduced(), d_model=128, num_heads=10,
        num_kv_heads=2, head_dim=64, kv_quant_int8=True, dtype="bfloat16",
        **kw)


def test_hymba_decode_through_the_kernel_across_the_ring(cuda):
    """Hymba decodes 24 steps past a 16-position prompt (the ring wraps at
    position 16) on the kernel and, on a copy of the same cache, on the
    plain version, both fed the kernel run's tokens: one launch a layer a
    step, the plain version only in its run, and logits within 2^-4 of
    the step's largest |logit| (bfloat16 activations carry the kernel's
    float32 rounding)."""
    import copy

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.models.model_zoo import build_model
    cfg = _hymba_g5()
    assert cfg.num_heads // cfg.num_kv_heads == 5
    model = build_model(cfg, cuda)
    params = model.init(seed=0)
    batch = TokenPipeline(4, 16, cfg.vocab_size).get(0, cuda)
    cache = model.init_cache(4, 40)
    logits, cache = model.prefill(params, batch, cache, last_only=True)
    plain_cache = copy.deepcopy(cache)
    tok = logits.argmax(-1).to(torch.int32)
    before, calls = decode_attention.launches, decode_attention_plain.calls
    for pos in range(16, 40):
        lk, cache = model.decode_step(params, tok, cache, pos)
        lp, plain_cache = model.decode_step(params, tok, plain_cache, pos,
                                            decode_attention_plain)
        share = float((lk - lp).abs().max()) / float(lp.abs().max())
        assert share <= 2.0 ** -4, (pos, share)
        tok = lk.argmax(-1).to(torch.int32)
    steps = 24 * cfg.num_layers
    assert decode_attention.launches - before == steps
    assert decode_attention_plain.calls - calls == steps
    for kv, st in cache:
        assert kv.k.shape[1] == 16 and kv.k.dtype == torch.int8
        assert st.h.dtype == torch.float32 and st.h.is_cuda


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1_5b"])
def test_recurrent_decode_step_makes_no_host_sync(cuda, arch):
    """A recurrent decode step (bfloat16; Hymba with the int8 KV store and
    the kernel) runs under the sync debug mode "error"."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4,
                              kv_quant_int8=True, dtype="bfloat16")
    model = build_model(cfg, cuda)
    params = model.init(seed=0)
    batch = TokenPipeline(4, 16, cfg.vocab_size).get(0, cuda)
    cache = model.init_cache(4, 24)
    logits, cache = model.prefill(params, batch, cache, last_only=True)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pos in (16, 17):
            logits, cache = model.decode_step(params, tok, cache, pos)
            tok = logits.argmax(-1).to(torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tok.shape == (4, 1) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch,imc", [("xlstm_125m", False),
                                      ("hymba_1_5b", False),
                                      ("hymba_1_5b", True)])
def test_recurrent_train_step_on_the_card_matches_the_cpu(cuda, arch, imc):
    """One ``make_train_step`` step of the reduced config (xLSTM with an
    sLSTM block) on the card against the CPU (float32, TF32 off): loss
    rtol 1e-5, grad_norm rtol 1e-4, parameters within 2 lr; Hymba with
    ``imc_linear`` launches ``imc_mvm`` once a layer, xLSTM never."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4,
                              imc_linear=imc)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        state = init_train_state(build_model(cfg, "cpu"), seed=0)
        if dev != "cpu":
            state.params.to(dev)
            state.opt["mu"] = [t.to(dev) for t in state.opt["mu"]]
            state.opt["nu"] = [t.to(dev) for t in state.opt["nu"]]
        batch = TokenPipeline(4, 64, cfg.vocab_size).get_for(cfg, 0, dev)
        before, plain = imc_mvm.launches, imc_mvm_plain.calls
        state, m = make_train_step(model, tcfg)(state, batch)
        if dev != "cpu":
            assert imc_mvm.launches - before == (cfg.num_layers
                                                 if imc else 0)
            assert imc_mvm_plain.calls == plain
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in state.params.parameters()])
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=1e-4)
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 2e-3 + 1e-6


@pytest.mark.parametrize("arch", ["whisper_medium", "internvl2_76b"])
def test_encdec_and_vlm_decode_on_the_card_equals_the_cpu(cuda, arch):
    """``serve.generate`` of the reduced encoder-decoder and VLM (float32,
    the int8 KV store, so the kernel on the card) on the card against the
    same parameters and prompt on the CPU (TF32 off): equal greedy
    tokens, each step's logits within 2^-6 of its largest |logit| (a K/V
    element on a rounding boundary may take the other int8 code), and
    ``decode_attention`` launched once a decoder layer a step, its plain
    version never."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build_model

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch).reduced(), kv_quant_int8=True)
    params = build_model(cfg, "cpu").init(seed=0)
    batch = TokenPipeline(3, 32, cfg.vocab_size).get_for(cfg, 0, "cpu")
    gen = 8
    want = serve.generate(build_model(cfg, "cpu"), params, batch, gen,
                          keep_logits=True)
    before, plain = decode_attention.launches, decode_attention_plain.calls
    got = serve.generate(build_model(cfg, cuda), copy.deepcopy(params).to(
        cuda), {k: v.to(cuda) for k, v in batch.items()}, gen,
        keep_logits=True)
    torch.cuda.synchronize()
    assert decode_attention.launches - before == cfg.num_layers * (gen - 1)
    assert decode_attention_plain.calls == plain
    assert got.start == want.start and got.cache_len == want.cache_len
    torch.testing.assert_close(got.tokens.cpu(), want.tokens, rtol=0, atol=0)
    for a, b in zip(got.logits, want.logits):
        share = float((a.cpu() - b).abs().max()) / float(b.abs().max())
        assert share <= 2.0 ** -6, share


# ------------------------------------------------- gradient compression --

@pytest.mark.parametrize("frac", [0.01, 0.25])
def test_topk_mask_on_the_card_equals_the_cpu(cuda, frac):
    """The unique-key top-k mask on the card selects exactly the CPU's
    coordinates, on many ties and zeros (ties to the lower flat index)."""
    from repro_torch.dist import compression as C

    rng = np.random.default_rng(3)
    for shape in ((1_000_003,), (333, 1024), (7,)):
        x = (rng.integers(-6, 7, size=shape) / 4.0).astype(np.float32)
        x[rng.random(shape) < 0.05] = -0.0
        want = C._topk_mask(torch.from_numpy(x), frac)
        got = C._topk_mask(torch.from_numpy(x).to(cuda), frac)
        assert int(got.sum()) == C.topk_count(x.size, frac)
        assert torch.equal(got.cpu(), want)


def test_int8_rounding_with_a_cuda_generator(cuda):
    """int8 codes in [-127, 127], within one scale step of the input, the
    same key the same draws, another key other draws, unbiased over
    keys; seeding makes no host sync."""
    from repro_torch.dist import compression as C

    x = torch.randn(4096, 257, device=cuda) * 1e-3
    torch.cuda.set_sync_debug_mode("error")
    try:
        q, s = C._int8_quantize(x, C.per_step_key(0, 1))
        out = C._int8_stochastic(x, C.per_step_key(0, 1))
        again = C._int8_stochastic(x, C.per_step_key(0, 1))
        other = C._int8_stochastic(x, C.per_step_key(0, 2))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(q, q.round()) and float(q.abs().max()) <= 127
    assert bool(((q * s - x).abs() <= s).all())
    assert torch.equal(out, q * s) and torch.equal(out, again)
    assert not torch.equal(out, other)
    err = torch.stack([C._int8_stochastic(x[:8], C.per_step_key(k, 0))
                       - x[:8] for k in range(64)]).double()
    assert abs(float(err.mean())) < 0.05 * float(s)


def test_dcn_allreduce_tree_on_a_1_rank_nccl_group(cuda, tmp_path):
    """``dcn_allreduce_tree`` and ``cross_pod_allreduce`` through NCCL on
    a 1-rank group equal the emulated route's one-pod fold, bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import compression as C

    rng = np.random.default_rng(5)
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
         for s in ((64, 33), (129,), (1,))]
    key = C.per_step_key(4, 2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        for method in ("none", "int8", "topk", "topk_ef"):
            e = [torch.randn_like(t) for t in g] if method == "topk_ef" \
                else []
            red, new_e = C.dcn_allreduce_tree(
                [t[None] for t in g], [t[None] for t in e] or {}, mesh,
                "pod", method, 0.1, key)
            sent, kept = C.dcn_send(g, e or {}, method, 0.1,
                                    C.fold_in(key, 0))
            for a, b in zip(red, sent):
                assert torch.equal(a, torch.zeros_like(b) + b)
            for a, b in zip(new_e or [], kept or []):
                assert torch.equal(a[0], b)
            if method != "topk_ef":
                got = C.cross_pod_allreduce(g[0], mesh, "pod", method, 0.1,
                                            key)
                want = {"none": g[0], "topk": C._topk(g[0], 0.1),
                        "int8": C._int8_stochastic(
                            g[0], C.fold_in(key, 0))}[method]
                assert torch.equal(got, want)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def test_topk_ef_train_step_on_the_card_matches_the_cpu(cuda):
    """One emulated ``topk_ef`` step over 2 pods of the reduced Qwen
    (float32, TF32 off) on the card against the CPU: loss within 1e-5,
    grad norm within 1e-3 (a near-tied coordinate may be sent on one
    side and kept on the other), parameters within 2 lr; the residuals
    hold what was not sent: nonzero, finite, (2, *shape)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("qwen2_7b").reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), dcn_pods=2,
                       dcn_compression="topk_ef", dcn_topk_frac=0.25)
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, "cpu")
        state = init_train_state(model, 0, tcfg)
        model = build_model(cfg, dev)
        state.params.to(dev)
        state.opt["mu"] = [t.to(dev) for t in state.opt["mu"]]
        state.opt["nu"] = [t.to(dev) for t in state.opt["nu"]]
        state.ef = [t.to(dev) for t in state.ef]
        batch = TokenPipeline(4, 64, cfg.vocab_size).get_for(cfg, 0, dev)
        step = make_train_step(model, tcfg)
        assert step.dcn_route == "emulated" and step.dcn_pods == 2
        state, m = step(state, batch)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in state.params.parameters()],
                         [e.cpu() for e in state.ef], m["dcn_bytes"])
    (lc, gc, pc, ec, bc), (lg, gg, pg, eg, bg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=1e-3)
    assert bg == bc
    for a, b in zip(pg, pc):
        assert float((a - b).abs().max()) <= 2e-3 + 1e-6
    for a, b in zip(eg, ec):
        assert a.shape == b.shape and a.shape[0] == 2
        assert bool(torch.isfinite(a).all())
    assert sum(float(e.abs().sum()) for e in eg) > 0


# --------------------------------------------------------------------------
# the mesh routes on the card: 2 processes sharing it in a gloo group
# --------------------------------------------------------------------------

def test_two_rank_fused_routes_on_the_card_equal_one_process(cuda, tmp_path):
    import _torch_mesh_ranks as MR
    from repro_torch.serve import (
        OMSConfig,
        encode_queries,
        oms_plan,
        oms_search_encoded,
        search_database,
        shard_database,
    )

    rng = np.random.default_rng(27)
    refs = rng.choice([-1, 1], size=(3000, 256)).astype(np.int8)
    refs[2000:2100] = refs[:100]               # ties across the shards
    decoys = -refs
    q = np.concatenate([refs[:20], rng.choice([-1, 1], size=(12, 256))
                        .astype(np.int8)])
    prec = rng.uniform(400, 1600, 3000).astype(np.float32)
    qprec = np.sort(rng.uniform(420, 1650, 32).astype(np.float32))
    inputs = dict(refs=refs, decoys=decoys, q=q, prec=prec, qprec=qprec)
    got = MR.spawn(MR.card_worker, 2, tmp_path, inputs, 300)
    t = {n: torch.from_numpy(inputs[n]).to(cuda) for n in ("refs", "decoys",
                                                          "q")}
    db = shard_database(t["refs"], decoys=t["decoys"], fused=True)
    odb = shard_database(t["refs"], decoys=t["decoys"], fused=True,
                         precursor=prec)
    plan = oms_plan(odb, qprec, OMSConfig(**MR.CFG))
    want = {"exact": search_database(db, t["q"], MR.K),
            "oms": oms_search_encoded(odb, encode_queries(odb, t["q"]), plan,
                                      MR.K)}
    for res in got:
        assert res["rows_held"] == 3000
        assert res["launches"][0] >= 1 and res["launches"][1] >= 1
        for name, (wi, wv) in want.items():
            np.testing.assert_array_equal(res[name][0], wi.cpu().numpy())
            np.testing.assert_array_equal(res[name][1], wv.cpu().numpy())


# --------------------------------------------------------------------------
# the dense LM over a mesh: the kernels at a rank's local shapes, and the
# launchers on a 1-rank NCCL group
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", [2, 4])
def test_imc_mvm_on_a_ranks_ff_shard_matches_plain(cuda, model):
    """``imc_mvm`` at the shape one rank of a ``model``-sharded Qwen2-7B
    FFN down-projection launches it (its ff shard: 18,944 / model columns,
    whole 128-column tiles), bit for bit against the plain version."""
    from repro_torch.core.imc.array import ArrayConfig, default_full_scale

    acfg = ArrayConfig(adc_bits=6, bits_per_cell=3)
    g = torch.Generator(device=cuda).manual_seed(model)
    Q, R, Dp = 256, 3584, 18944 // model
    assert Dp % acfg.cols == 0
    q = torch.randint(-3, 4, (Q, Dp), generator=g, device=cuda).float()
    w = torch.randint(-3, 4, (R, Dp), generator=g, device=cuda).float()
    kw = dict(full_scale=default_full_scale(acfg), tile_cols=acfg.cols,
              dac_limit=acfg.dac_levels, adc_levels=acfg.adc_levels)
    launches = imc_mvm.launches
    got = imc_mvm(q, w, **kw)
    assert imc_mvm.launches == launches + 1
    assert torch.equal(got, imc_mvm_plain(q, w, **kw))


@pytest.mark.parametrize("model", [2, 4])
def test_decode_attention_on_a_ranks_cache_block_matches_plain(cuda, model):
    """``decode_attention`` on the cache block one rank of a (1, model)
    mesh holds for Qwen2-7B at 32 x (512 + 16): 28 / model query heads
    over 4 / model kv heads (G = 7), within 2e-4 of the plain version."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(model)
    B, S, KV, G, hd = 32, 528, 4 // model, 7, 128
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda) * hd ** -0.5
    k = torch.randint(-127, 128, (B, S, KV, hd), generator=g, device=cuda,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, S, KV, hd), generator=g, device=cuda,
                      dtype=torch.int8)
    ks = torch.rand((B, S, KV), generator=g, device=cuda) / 127
    vs = torch.rand((B, S, KV), generator=g, device=cuda) / 127
    launches = decode_attention.launches
    got = decode_attention(q, k, v, ks, vs, S - 1)
    assert decode_attention.launches == launches + 1
    want = decode_attention_plain(q, k, v, ks, vs, S - 1)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_lm_launchers_on_a_1_rank_nccl_group(cuda, tmp_path, capsys):
    """``launch.train`` and ``launch.serve`` (reduced Qwen2-7B, the
    kernels on) on a 1-rank NCCL group: the (1, 1) ``DeviceMesh`` of
    ``make_debug_mesh``, DTensor parameters, both kernels launched, the
    greedy tokens of the run without a group and the same losses."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch import serve, train

    train_argv = ["--arch", "qwen2_7b", "--reduced", "--steps", "2",
                  "--imc-linear", "--batch", "4", "--seq", "64",
                  "--log-every", "1"]
    serve_argv = ["--arch", "qwen2_7b", "--reduced", "--kv-quant",
                  "--batch", "4", "--prompt-len", "64", "--gen", "8"]
    alone = serve.main(serve_argv)
    train.main(train_argv)
    capsys.readouterr()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        imc, dec = imc_mvm.launches, decode_attention.launches
        st = train.main(train_argv)
        run = serve.main(serve_argv)
        assert imc_mvm.launches == imc + 4      # 2 layers x 2 steps
        assert decode_attention.launches == dec + 2 * 7
        assert all(SH.on_mesh(p) for p in st.params.parameters())
    finally:
        SH.set_mesh(None)
        dist.destroy_process_group()
    printed = capsys.readouterr().out
    assert printed.count("mesh: {'data': 1, 'model': 1} devices=1") == 2
    assert torch.equal(run.tokens.cpu(), alone.tokens.cpu())


# a rank's block of each mesh family's int8 cache at 32 x (512 + 16):
# (name, KV a rank, G, hd, S, valid_len at the last step); Whisper's cache
# is sized as the launcher sizes it (frames, tokens and 16 more) and its
# decode starts after its 256 tokens
FAMILY_BLOCKS = [("deepseek_moe_16b model 2", 8, 1, 128, 528, 527),
                 ("whisper_medium model 2", 8, 1, 64, 528, 271),
                 ("internvl2_76b model 2", 4, 8, 128, 528, 527),
                 ("internvl2_76b model 4", 2, 8, 128, 528, 527)]


@pytest.mark.parametrize("name,KV,G,hd,S,valid", FAMILY_BLOCKS,
                         ids=[b[0].replace(" ", "-") for b in FAMILY_BLOCKS])
def test_decode_attention_on_a_family_ranks_block_matches_plain(
        cuda, name, KV, G, hd, S, valid):
    """``decode_attention`` on the cache block one rank of a (1, model)
    mesh holds for the MoE, encoder-decoder and VLM cells, within 2e-4 of
    the plain version."""
    from repro_torch.kernels.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(KV * G + hd)
    B = 32
    q = torch.randn((B, KV, G, hd), generator=g, device=cuda) * hd ** -0.5
    k = torch.randint(-127, 128, (B, S, KV, hd), generator=g, device=cuda,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (B, S, KV, hd), generator=g, device=cuda,
                      dtype=torch.int8)
    ks = torch.rand((B, S, KV), generator=g, device=cuda) / 127
    vs = torch.rand((B, S, KV), generator=g, device=cuda) / 127
    launches = decode_attention.launches
    got = decode_attention(q, k, v, ks, vs, valid)
    assert decode_attention.launches == launches + 1
    want = decode_attention_plain(q, k, v, ks, vs, valid)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_moe_serve_launcher_on_a_1_rank_nccl_group(cuda, tmp_path, capsys):
    """``launch.serve --arch deepseek_moe_16b`` (reduced, the int8 cache)
    on a 1-rank NCCL group: the (1, 1) ``DeviceMesh``, the kernel launched
    on every decode step of both layers, the greedy tokens of the run
    without a group."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch import serve

    argv = ["--arch", "deepseek_moe_16b", "--reduced", "--kv-quant",
            "--batch", "4", "--prompt-len", "64", "--gen", "8"]
    alone = serve.main(argv)
    capsys.readouterr()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        dec = decode_attention.launches
        run = serve.main(argv)
        assert decode_attention.launches == dec + 2 * 7
    finally:
        SH.set_mesh(None)
        dist.destroy_process_group()
    printed = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} devices=1" in printed
    assert torch.equal(run.tokens.cpu(), alone.tokens.cpu())


@pytest.mark.parametrize("arch,kv_quant", [("xlstm_125m", False),
                                           ("hymba_1_5b", True)])
def test_recurrent_serve_launcher_on_a_1_rank_nccl_group(cuda, tmp_path,
                                                         capsys, arch,
                                                         kv_quant):
    """``launch.serve`` of the recurrent (xLSTM) and hybrid (Hymba)
    families (reduced; Hymba with the int8 cache) on a 1-rank NCCL group:
    the (1, 1) ``DeviceMesh``, the recurrent states and the KV cache held
    as the rank's blocks, Hymba's kernel launched on every decode step of
    both layers, the greedy tokens of the run without a group."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--reduced", "--batch", "4", "--prompt-len",
            "32", "--gen", "8"] + (["--kv-quant"] if kv_quant else [])
    alone = serve.main(argv)
    capsys.readouterr()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        dec = decode_attention.launches
        run = serve.main(argv)
        assert decode_attention.launches == dec + (2 * 7 if kv_quant else 0)
    finally:
        SH.set_mesh(None)
        dist.destroy_process_group()
    printed = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} devices=1" in printed
    assert torch.equal(run.tokens.cpu(), alone.tokens.cpu())


@pytest.mark.parametrize("arch,imc", [("xlstm_125m", False),
                                      ("hymba_1_5b", True)])
def test_recurrent_train_launcher_on_a_1_rank_nccl_group(cuda, tmp_path,
                                                         capsys, arch, imc):
    """``launch.train`` of xLSTM and of Hymba with ``--imc-linear``
    (reduced) on a 1-rank NCCL group, 2 steps: the parameters DTensors on
    the (1, 1) mesh, Hymba's ``imc_mvm`` launched once a layer a step, and
    every parameter within 2 lr a step of the run without a group (the
    mesh path's products may round otherwise, and AdamW's normalised
    update carries a last-bit difference up to a whole lr)."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as SH
    from repro_torch.kernels.imc_mvm import imc_mvm
    from repro_torch.launch import train

    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "32", "--log-every", "1"] + (
                ["--imc-linear"] if imc else [])
    alone = train.main(argv)
    capsys.readouterr()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        launches = imc_mvm.launches
        st = train.main(argv)
        assert imc_mvm.launches == launches + (2 * 2 if imc else 0)
        assert all(SH.on_mesh(p) for p in st.params.parameters())
        got = [SH.full_value(p).detach().cpu() for p in
               st.params.parameters()]
    finally:
        SH.set_mesh(None)
        dist.destroy_process_group()
    printed = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} devices=1" in printed
    for a, b in zip(got, alone.params.parameters(), strict=True):
        assert torch.isfinite(a).all()
        assert float((a - b.detach().cpu()).abs().max()) <= 2 * 3e-4 * 2 \
            + 1e-6
