"""The port's CUDA kernels (exact and banded top-k, the full Hamming
similarity of clustering, the Eq. 1 encoder and the analog PCM MVM)
against their plain PyTorch versions, the clustering path around the
Hamming kernel, and the tuner's launch knobs, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
False (decided inside the fixture, never at import). Run on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: exact. Indices, scores, similarities, HVs and labels are
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
    if layout == "absent":
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
