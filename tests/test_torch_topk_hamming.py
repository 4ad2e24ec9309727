"""The port's ``topk_hamming`` and ``topk_hamming_banded`` (CPU paths)
against the JAX package's ``topk_hamming_pallas`` and
``topk_hamming_banded_pallas`` (interpret mode on the CPU) and their
``ref.py`` oracles; ``canonicalize_overflow_slots`` against the
reference's.

Tolerance: exact (indices, scores, tie order, sentinel-masked slots).
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.topk_hamming import canonicalize_overflow_slots as jcanon
from repro.kernels.topk_hamming import (
    topk_hamming_banded_pallas,
    topk_hamming_pallas,
)
from repro.kernels.topk_hamming.ref import topk_hamming_banded_ref as jbref
from repro.kernels.topk_hamming.ref import topk_hamming_ref as jref
from repro_torch.core.hd.similarity import INT32_MIN
from repro_torch.kernels.topk_hamming import (
    canonicalize_overflow_slots,
    topk_hamming,
    topk_hamming_banded,
    topk_hamming_banded_plain,
    topk_hamming_plain,
)
from repro_torch.kernels.topk_hamming.ops import (
    BANDED_GROUP,
    BANDED_TILE_ROWS,
    BLOCK_Q_CHOICES,
    MMA_CHUNK,
    MMA_ROWS,
    TILE_ROWS,
    TILE_WORDS,
    banded_smem,
    banded_tiles,
    block_smem,
    clip_bands,
    on_tensor_cores,
    pick_block_q,
    plan_banded,
    plan_scan,
    scores_plain,
    split_rows,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)


def _operands(rng, q, r, d, packed, dup=False):
    if packed:
        rows = rng.integers(0, 2**32, (r, d // 32), dtype=np.uint32)
        qs = rng.integers(0, 2**32, (q, d // 32), dtype=np.uint32)
    else:
        rows = rng.choice([-1, 1], size=(r, d)).astype(np.int8)
        qs = rng.choice([-1, 1], size=(q, d)).astype(np.int8)
    if dup:
        rows = np.concatenate([rows, rows, rows])
        qs[: min(q, r)] = rows[: min(q, r)]
    return qs, rows


def _port(a):
    a = np.asarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                             else a).copy())


def _check(q, rows, d, k, nv):
    want_i, want_v = topk_hamming_pallas(jnp.asarray(q), jnp.asarray(rows),
                                         dim=d, k=k, num_valid=nv)
    oracle = jref(jnp.asarray(q), jnp.asarray(rows), d, k, num_valid=nv)
    got = topk_hamming(_port(q), _port(rows), dim=d, k=k, num_valid=nv)
    for want in ((want_i, want_v), oracle):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# (Q, R, D, packed, k, num_valid, duplicate rows)
CASES = [
    (3, 130, 64, True, 4, None, False),      # ragged R (not a tile multiple)
    (5, 200, 32, True, 6, 150, False),       # num_valid < R
    (4, 60, 64, True, 9, 5, False),          # k > num_valid: masked slots
    (2, 23, 32, True, 23, None, False),      # k = R
    (6, 40, 64, True, 8, None, True),        # duplicate rows: ties
    (4, 90, 40, False, 5, None, False),      # int8, D % 32 != 0
    (3, 51, 100, False, 51, 31, True),       # int8, k = R, ties, masked
]


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup", CASES)
def test_topk_hamming_matches_reference(Q, R, D, packed, k, nv, dup):
    rng = np.random.default_rng(Q * 100 + R + D)
    q, rows = _operands(rng, Q, R // 3 if dup else R, D, packed, dup)
    _check(q, rows, D, k, nv)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 12), st.integers(1, 300), st.sampled_from([32, 96]),
       st.integers(1, 8), st.integers(0, 320))
def test_topk_hamming_random_shapes(q, r, d, k, nv):
    k = min(k, r)
    rng = np.random.default_rng(q * 7919 + r * 131 + d + k)
    qs, rows = _operands(rng, q, r, d, True)
    _check(qs, rows, d, k, nv)


def test_plain_is_the_cpu_path_and_counts_no_launch():
    rng = np.random.default_rng(1)
    q, rows = _operands(rng, 3, 40, 64, True)
    before = topk_hamming.launches
    a = topk_hamming(_port(q), _port(rows), dim=64, k=3)
    b = topk_hamming_plain(_port(q), _port(rows), dim=64, k=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert topk_hamming.launches == before


H100_SMEM = 232448  # bytes of shared memory a block may opt into
H100_SMS = 132


@pytest.mark.parametrize("Q,want", [(1, 8), (8, 8), (9, 16), (16, 16),
                                    (17, 32), (32, 32), (100, 32)])
def test_block_q_is_the_smallest_that_covers_the_batch(Q, want):
    assert pick_block_q(Q, 256, 4, H100_SMEM) == want


def test_block_q_shrinks_to_fit_shared_memory():
    # packed: 32 queries' lists of k = 380 do not fit beside the
    # tensor-core scan's ring, 16 do; a limit just under the 16-query
    # block's shared memory leaves 8 (the POPC scan); under the 8-query
    # block's, none
    assert pick_block_q(32, 256, 380, H100_SMEM) == 16
    assert pick_block_q(32, 256, 4, block_smem(16, 256, 4) - 1) == 8
    with pytest.raises(ValueError):
        pick_block_q(8, 256, 4, block_smem(8, 256, 4) - 1)
    assert BLOCK_Q_CHOICES == (8, 16, 32)


def test_int8_block_q_follows_the_resident_query_words():
    # int8 banks keep hd::scan_rows: 32 resident queries of 2048 words do
    # not fit; 16 do
    assert pick_block_q(32, 2048, 4, H100_SMEM, packed=False) == 16
    assert pick_block_q(32, 256, 4, 4 * 128 * 36 + 4 * 8 * 264,
                        packed=False) == 8
    with pytest.raises(ValueError):
        pick_block_q(8, 256, 4, 4 * 128 * 36, packed=False)


# (Q, expected query block, rows per split, splits) at the served bank
# (1,162,392 rows, 256 words, k = 4) with no table: 4 blocks per SM on 132
# SMs, splits of whole 256-row block steps on the tensor cores (16 and 32
# queries), of whole 128-row tiles on the POPC scan (8 queries)
@pytest.mark.parametrize("Q,bq,rows,splits", [
    (1, 8, 2304, 505), (4, 8, 2304, 505), (8, 8, 2304, 505),
    (16, 16, 2304, 505), (32, 32, 2304, 505), (33, 32, 4608, 253)])
def test_plan_scan_at_the_served_shapes(Q, bq, rows, splits):
    assert plan_scan(Q, 1_162_392, 256, 4, H100_SMEM, H100_SMS, 0,
                     4) == (bq, rows, splits)
    step = MMA_ROWS if on_tensor_cores(True, bq) else TILE_ROWS
    assert rows % step == 0 and (splits - 1) * rows < 1_162_392


# (packed, query block) -> whether the exact scan runs on the tensor cores
@pytest.mark.parametrize("packed,bq,mma", [
    (True, 8, False), (True, 16, True), (True, 32, True),
    (False, 8, False), (False, 16, False), (False, 32, False)])
def test_the_query_block_picks_the_scan(packed, bq, mma):
    assert on_tensor_cores(packed, bq) == mma
    # each scan's own shared memory: the 8-query POPC block's resident
    # words and 128-row tile, the tensor-core block's ring and stages
    tiles = 4 * (bq * 256 + TILE_WORDS + 2 * bq * 4)
    assert (block_smem(bq, 256, 4, packed) == tiles) == (not mma)
    # and its own split step at the served bank
    rows, _ = split_rows(32, 1_162_392, bq, H100_SMS, 1, packed)
    assert rows % (MMA_ROWS if mma else TILE_ROWS) == 0


def _kslot_bytes(words: np.ndarray, bit_of_slot) -> np.ndarray:
    """(n, W) uint32 words -> (n, 32 W) bytes in the kernel's k order: word
    w fills k = 32 w .. 32 w + 31, k-slot s (4 bytes) holding bits s,
    s + 8, s + 16, s + 24; each byte bit_of_slot(bit)."""
    shifts = np.array([s + 8 * j for s in range(8) for j in range(4)],
                      dtype=np.uint32)
    bits = (words[:, :, None] >> shifts) & 1
    return bit_of_slot(bits.astype(np.int64)).reshape(words.shape[0], -1)


# (W, dim): W = 1, 3, 8 and 65 words, dim < 32 W with random padding bits
@pytest.mark.parametrize("W,dim", [(1, 32), (1, 20), (3, 96), (3, 70),
                                   (8, 256), (8, 250), (65, 2080),
                                   (65, 2070)])
@pytest.mark.parametrize("form", ["kernel", "pm1"])
def test_scan_arithmetic_mirrors_scores_plain(W, dim, form):
    """The tensor-core scan's integer arithmetic in numpy, held against
    scores_plain. "kernel": bank bits as int8 -128 / 0 bytes, query bits
    as +-1, dim - 2 popcount(q) - dot / 64; "pm1": both as +-1 (the
    hamming_pop.cu form), dim - (32 staged - dot). Words are staged in
    32-word ring stages (MMA_CHUNK), zero past W on both sides."""
    rng = np.random.default_rng(W * 1000 + dim)
    q = rng.integers(0, 2**32, (5, W), dtype=np.uint32)
    r = rng.integers(0, 2**32, (40, W), dtype=np.uint32)
    r[7] = q[2]                  # an exact match
    r[9] = ~q[3]                 # every bit differs
    staged = -(-W // MMA_CHUNK) * MMA_CHUNK
    pad = ((0, 0), (0, staged - W))
    qs, rs = np.pad(q, pad), np.pad(r, pad)
    qb = _kslot_bytes(qs, lambda b: 2 * b - 1)
    if form == "kernel":
        rb = _kslot_bytes(rs, lambda b: -128 * b)
        dot = qb @ rb.T
        assert (dot % 128 == 0).all()
        pc = np.vectorize(int.bit_count)(q.astype(object)).sum(axis=1)
        got = dim - 2 * pc[:, None] - (dot >> 6)
    else:
        dot = qb @ _kslot_bytes(rs, lambda b: 2 * b - 1).T
        got = dim - (32 * staged - dot)
    want = scores_plain(_port(q), _port(r), dim).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["k0", "kR", "dtype", "width"])
def test_wrapper_rejects_bad_operands(bad):
    q = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros((5, 2), dtype=torch.int32)
    k = {"k0": 0, "kR": 6}.get(bad, 2)
    if bad == "dtype":
        q = q.to(torch.int64)
        r = r.to(torch.int64)
    if bad == "width":
        r = torch.zeros((5, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        topk_hamming(q, r, dim=64, k=k)


# --------------------------------------------------------------------------
# banded (OMS) search
# --------------------------------------------------------------------------

def _bands(rng, q, r, kind):
    """(starts, lens) per query: random mixes of empty, narrow and wide
    bands, or one named edge case."""
    if kind == "random":
        starts = rng.integers(-3, r + 1, q)
        lens = np.minimum(rng.integers(0, r + 1, q), r + 3 - starts)
    elif kind == "empty":
        starts, lens = rng.integers(0, r, q), np.zeros(q, np.int64)
    elif kind == "narrow":      # narrower than k: overflow slots
        starts, lens = rng.integers(0, r - 3, q), rng.integers(0, 3, q)
    elif kind == "far_apart":   # one 8-query block, bands at both ends
        starts = np.where(np.arange(q) % 2 == 0, 0, r - 40)
        lens = np.full(q, 30)
    elif kind == "past_valid":  # bands running past num_valid and R
        starts, lens = rng.integers(r // 2, r, q), np.full(q, r)
    return starts.astype(np.int32), lens.astype(np.int32)


# (Q, R, D, packed, k, num_valid, duplicate rows, bands)
BANDED_CASES = [
    (7, 300, 64, True, 5, None, False, "random"),      # ragged Q and R
    (9, 130, 32, True, 4, 100, False, "past_valid"),   # num_valid < R
    (5, 200, 64, True, 6, None, False, "empty"),       # every band empty
    (8, 150, 64, True, 7, None, False, "narrow"),      # bands narrower than k
    (8, 260, 32, True, 3, None, False, "far_apart"),   # far apart, one block
    (6, 40, 64, True, 8, None, True, "random"),        # duplicate rows: ties
    (5, 90, 40, False, 5, 70, False, "random"),        # int8, D % 32 != 0
    (3, 51, 100, False, 51, None, True, "narrow"),     # int8, k = R, ties
]


def _check_banded(q, rows, starts, lens, d, k, nv, num_tiles=None):
    jq, jr, js, jl = (jnp.asarray(a) for a in (q, rows, starts, lens))
    want = topk_hamming_banded_pallas(jq, jr, js, jl, dim=d, k=k,
                                      num_valid=nv, num_tiles=num_tiles)
    oracle = jbref(jq, jr, js, jl, d, k, num_valid=nv)
    got = topk_hamming_banded(_port(q), _port(rows), torch.from_numpy(starts),
                              torch.from_numpy(lens), dim=d, k=k,
                              num_valid=nv, num_tiles=num_tiles)
    for w in (want, oracle):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(w[1]))


@pytest.mark.parametrize("Q,R,D,packed,k,nv,dup,kind", BANDED_CASES)
def test_banded_matches_reference(Q, R, D, packed, k, nv, dup, kind):
    rng = np.random.default_rng(Q * 100 + R + D + k)
    q, rows = _operands(rng, Q, R // 3 if dup else R, D, packed, dup)
    starts, lens = _bands(rng, Q, rows.shape[0], kind)
    _check_banded(q, rows, starts, lens, D, k, nv)


def test_banded_tile_budget_from_the_plan():
    """Bands crossing 128-row tiles under the tightest budget the plan's
    contract allows, one tile more, and none."""
    rng = np.random.default_rng(0)
    q, rows = _operands(rng, 12, 520, 96, True)
    starts = (rng.integers(0, 3, 12) * 128 + 100).astype(np.int32)
    lens = np.minimum(rng.integers(60, 200, 12), 520 - starts).astype(
        np.int32)
    tight = max(-(-int((starts + lens)[i:i + 8].max()) // 128)
                - int(starts[i:i + 8].min()) // 128 for i in (0, 8))
    for nt in (tight, tight + 1, None):
        _check_banded(q, rows, starts, lens, 96, 5, None, nt)


@settings(max_examples=4, deadline=None)
@given(st.integers(1, 20), st.integers(1, 260), st.integers(1, 9))
def test_banded_random_shapes(q, r, k):
    k = min(k, r)
    rng = np.random.default_rng(q * 7919 + r * 131 + k)
    qs, rows = _operands(rng, q, r, 64, True)
    starts, lens = _bands(rng, q, r, "random")
    _check_banded(qs, rows, starts, lens, 64, k, None)


def test_two_bands_match_the_reference_routes():
    """(B, Q) bands in one call equal the reference's masked per-shard
    oracle and its two-launch banded route after canonicalization."""
    from repro.serve.db_search import _local_oms_topk, _local_oms_topk_fused
    rng = np.random.default_rng(5)
    Q, R, d, k = 9, 300, 64, 6
    q, rows = _operands(rng, Q, R, d, True)
    s0 = rng.integers(0, 120, Q)
    s1 = rng.integers(150, 280, Q)
    starts = np.stack([s0, s1]).astype(np.int32)
    ends = np.stack([s0 + rng.integers(0, 30, Q),
                     np.minimum(s1 + rng.integers(0, 40, Q), R)]).astype(
                         np.int32)
    js, je = jnp.asarray(starts), jnp.asarray(ends)
    ov, oi = _local_oms_topk(jnp.asarray(q), jnp.asarray(rows), 0, k, R, d,
                             True, js, je)
    fv, fi = _local_oms_topk_fused(jnp.asarray(q), jnp.asarray(rows), 0, k,
                                   R, d, js, je, num_tiles=3)
    fi = jcanon(fi, fv, js, je, R)
    got_i, got_v = topk_hamming_banded(
        _port(q), _port(rows), torch.from_numpy(starts),
        torch.from_numpy(ends - starts), dim=d, k=k, num_tiles=3)
    for wi, wv in ((oi, ov), (fi, fv)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(wv))


@pytest.mark.parametrize("bands", [1, 2])
def test_canonicalize_overflow_slots_matches_reference(bands):
    """Sentinel slots rewritten to the masked rows, for bands wider and
    narrower than k and empty bands, against the reference's function on
    the same filler indices."""
    rng = np.random.default_rng(bands)
    Q, R, k = 16, 64, 9
    cuts = np.sort(rng.integers(0, R + 1, (Q, 2 * bands)), axis=1)
    starts = cuts[:, 0::2].T.astype(np.int32)
    ends = cuts[:, 1::2].T.astype(np.int32)
    ends[:, :3] = starts[:, :3]                  # empty bands
    n_real = np.minimum((ends - starts).sum(0), k)
    vals = np.full((Q, k), INT32_MIN, np.int32)
    idx = rng.integers(R, 2 * R, (Q, k)).astype(np.int32)  # fillers
    for i in range(Q):
        vals[i, :n_real[i]] = np.sort(rng.integers(-50, 50, n_real[i]))[::-1]
        idx[i, :n_real[i]] = rng.integers(0, R, n_real[i])
    want = jcanon(jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(starts),
                  jnp.asarray(ends), R)
    got = canonicalize_overflow_slots(
        torch.from_numpy(idx), torch.from_numpy(vals),
        torch.from_numpy(starts if bands > 1 else starts[0]),
        torch.from_numpy(ends if bands > 1 else ends[0]), R)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_banded_plain_is_the_cpu_path_and_counts_no_launch():
    rng = np.random.default_rng(3)
    q, rows = _operands(rng, 4, 50, 64, True)
    starts, lens = _bands(rng, 4, 50, "random")
    args = (_port(q), _port(rows), torch.from_numpy(starts),
            torch.from_numpy(lens))
    before = topk_hamming_banded.launches
    a = topk_hamming_banded(*args, dim=64, k=3, canonicalize=False)
    b = topk_hamming_banded_plain(*args, dim=64, k=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert topk_hamming_banded.launches == before


def test_banded_wrapper_rejects_bad_bands():
    q = torch.zeros((3, 2), dtype=torch.int32)
    r = torch.zeros((9, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        topk_hamming_banded(q, r, torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32), dim=64, k=2)


# --------------------------------------------------------------------------
# the banded scan's launch plan (csrc/hd_banded_scan.cuh), on the CPU
# --------------------------------------------------------------------------

def _plan_bands(rng, Q, R, nbands, kind):
    """(B, Q) clipped bands [s, e): random mixes of empty, one-row and wide
    bands, bands ending inside a tile, all empty, or one band covering the
    whole bank."""
    if kind == "all_empty":
        s = rng.integers(0, R + 1, (nbands, Q))
        return s, s.copy()
    if kind == "whole":
        s = np.zeros((nbands, Q), np.int64)
        e = np.zeros((nbands, Q), np.int64)
        e[0] = R
        return s, e
    cuts = np.sort(rng.integers(0, R + 1, (Q, 2 * nbands)), axis=1)
    s, e = cuts[:, 0::2].T.copy(), cuts[:, 1::2].T.copy()
    if kind == "short":             # one-row bands, ending inside a tile
        e = np.minimum(s + 1, np.maximum(s, e))
    s[:, rng.random(Q) < 0.2] = e[:, rng.random(Q) < 0.2] = 0
    return s, np.maximum(s, e)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 70), st.integers(1, 2000), st.integers(1, 2),
       st.sampled_from(["random", "short", "all_empty", "whole"]),
       st.integers(1, 16), st.integers(1, 6), st.sampled_from([None, 1, 3]),
       st.integers(0, 2**31 - 1))
def test_banded_plan_covers_every_in_band_pair_once(Q, R, nbands, kind,
                                                    waves, sms, num_tiles,
                                                    seed):
    """Every in-band (query, row) pair lies in exactly one tile of one
    block of its query's group, and every tile a block walks meets a band
    of the group."""
    rng = np.random.default_rng(seed)
    s, e = _plan_bands(rng, Q, R, nbands, kind)
    plan = plan_banded(Q, R, 256, 4, nbands, num_tiles, sms, waves, 232448)
    assert plan.group == min(Q, BANDED_GROUP)
    assert plan.groups == -(-Q // plan.group) and plan.blocks >= 1
    col = np.arange(R)
    want = np.zeros((Q, R), np.int64)
    for b in range(nbands):
        want += (col >= s[b][:, None]) & (col < e[b][:, None])
    got = np.zeros((Q, R), np.int64)
    for g in range(plan.groups):
        q0, q1 = g * plan.group, min(Q, (g + 1) * plan.group)
        for x in range(plan.blocks):
            for a, bnd in banded_tiles(s, e, plan, g, x):
                assert 0 < bnd - a <= BANDED_TILE_ROWS
                tile = np.zeros(R, bool)
                tile[a:bnd] = True
                hit = want[q0:q1, a:bnd]
                assert hit.any()
                got[q0:q1] += want[q0:q1] * tile[None, :]
    np.testing.assert_array_equal(got, want)


def _emulate_banded(q, rows, s, e, d, k, plan):
    """The kernel's arithmetic in numpy: per (group, block) each query's k
    best rows of the block's tiles inside its bands, the slots it did not
    fill left at (INT32_MIN, R + slot); then the split merge's top-k of
    every block's slots (duplicates inserted once), by (value desc, row
    asc)."""
    R = rows.shape[0]
    scores = scores_plain(_port(q), _port(rows), d).numpy().astype(np.int64)
    out_i = np.zeros((q.shape[0], k), np.int64)
    out_v = np.zeros((q.shape[0], k), np.int64)
    for g in range(plan.groups):
        q0 = g * plan.group
        slots = {i: [] for i in range(q0, min(q.shape[0], q0 + plan.group))}
        for x in range(plan.blocks):
            tiles = banded_tiles(s, e, plan, g, x)
            for i in slots:
                cand = [(int(scores[i, r]), int(r)) for a, b in tiles
                        for r in range(a, b)
                        if ((r >= s[:, i]) & (r < e[:, i])).any()]
                cand.sort(key=lambda c: (-c[0], c[1]))
                cand = cand[:k] + [(INT32_MIN, R + j)
                                   for j in range(len(cand[:k]), k)]
                slots[i] += cand
        for i, cand in slots.items():
            merged = sorted(set(cand) | {(INT32_MIN, R + j) for j in
                                         range(k)},
                            key=lambda c: (-c[0], c[1]))[:k]
            out_v[i] = [c[0] for c in merged]
            out_i[i] = [c[1] for c in merged]
    return (torch.from_numpy(out_i.astype(np.int32)),
            torch.from_numpy(out_v.astype(np.int32)))


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 40), st.integers(8, 260), st.integers(1, 2),
       st.sampled_from(["random", "short", "all_empty", "whole"]),
       st.integers(1, 9), st.integers(1, 8), st.booleans(),
       st.integers(0, 2**31 - 1))
def test_banded_plan_emulation_matches_plain_and_reference(Q, R, nbands, kind,
                                                           k, waves, packed,
                                                           seed):
    """Per-block lists over the plan's tiles, folded by the split merge and
    canonicalized, equal topk_hamming_banded_plain and the reference's
    masked oracle (one band) or its per-band routes (two)."""
    rng = np.random.default_rng(seed)
    k = min(k, R)
    d = 64 if packed else 40
    q, rows = _operands(rng, Q, R, d, packed)
    s, e = _plan_bands(rng, Q, R, nbands, kind)
    st_, ln = torch.from_numpy(s.astype(np.int32)), torch.from_numpy(
        (e - s).astype(np.int32))
    cs, ce = clip_bands(st_, ln, R, Q, torch.device("cpu"))
    wpr = d // 32 if packed else -(-d // 4)
    plan = plan_banded(Q, R, wpr, k, nbands, None, 3, waves, 232448)
    got_i, got_v = _emulate_banded(q, rows, cs.numpy(), ce.numpy(), d, k,
                                   plan)
    got_i = canonicalize_overflow_slots(got_i, got_v, cs, ce, R)
    want = topk_hamming_banded_plain(_port(q), _port(rows), st_, ln, dim=d,
                                     k=k)
    assert torch.equal(got_i, want[0]) and torch.equal(got_v, want[1])
    if nbands == 1:
        oracle = jbref(jnp.asarray(q), jnp.asarray(rows), jnp.asarray(s[0]),
                       jnp.asarray(e[0] - s[0]), d, k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(oracle[0]))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(oracle[1]))


def test_f5_overlapping_bands_canonicalize_on_their_union():
    """The smallest input found: query 7's bands [0, 2) and [0, 4) overlap
    (the generator zeroes a later band's start), so the masked rows are
    those outside [0, 4) and the overflow slot holds row 4. Canonicalizing
    on the bands as two disjoint runs read [2, 0) as a run of -2 rows and
    wrote row 6; the reference's ``canonicalize_overflow_slots`` still
    does (ROADMAP.md, Queue 3, F5)."""
    Q, R, k, d = 8, 8, 5, 64
    rng = np.random.default_rng(1)
    q, rows = _operands(rng, Q, R, d, True)
    s, e = _plan_bands(rng, Q, R, 2, "random")
    assert (s[:, 7].tolist(), e[:, 7].tolist()) == ([0, 0], [2, 4])
    st_, ln = torch.from_numpy(s.astype(np.int32)), torch.from_numpy(
        (e - s).astype(np.int32))
    cs, ce = clip_bands(st_, ln, R, Q, torch.device("cpu"))
    plan = plan_banded(Q, R, d // 32, k, 2, None, 3, 1, 232448)
    got_i, got_v = _emulate_banded(q, rows, cs.numpy(), ce.numpy(), d, k,
                                   plan)
    got_i = canonicalize_overflow_slots(got_i, got_v, cs, ce, R)
    want = topk_hamming_banded_plain(_port(q), _port(rows), st_, ln, dim=d,
                                     k=k)
    assert torch.equal(got_i, want[0]) and torch.equal(got_v, want[1])
    assert got_i[7].tolist() == [1, 3, 2, 0, 4]
    ref = np.asarray(jcanon(jnp.asarray(got_i.numpy()),
                            jnp.asarray(got_v.numpy()), jnp.asarray(cs),
                            jnp.asarray(ce), R))
    assert ref[7].tolist() == [1, 3, 2, 0, 6]
    np.testing.assert_array_equal(ref[:7], got_i[:7].numpy())


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 12), st.integers(1, 80), st.integers(1, 4),
       st.integers(1, 12), st.booleans(), st.integers(0, 2**31 - 1))
def test_canonicalize_overlapping_and_unordered_bands_matches_plain(
        Q, R, nbands, k, packed, seed):
    """Bands drawn anywhere (overlapping, nested, out of order, empty, past
    the bank before clipping): the plain route's top-k with its overflow
    slots overwritten by filler, canonicalized, equals the plain route."""
    rng = np.random.default_rng(seed)
    k = min(k, R)
    d = 64 if packed else 40
    q, rows = _operands(rng, Q, R, d, packed)
    s = rng.integers(-2, R + 3, (nbands, Q))
    ln = rng.integers(0, R // 2 + 3, (nbands, Q))
    st_, ln_ = (torch.from_numpy(a.astype(np.int32)) for a in (s, ln))
    want_i, want_v = topk_hamming_banded_plain(_port(q), _port(rows), st_,
                                               ln_, dim=d, k=k)
    sentinel = want_v == INT32_MIN
    filler = torch.where(sentinel, torch.full_like(want_i, R + 7), want_i)
    cs, ce = clip_bands(st_, ln_, R, Q, torch.device("cpu"))
    got = canonicalize_overflow_slots(filler, want_v, cs, ce, R)
    assert torch.equal(got, want_i)


@pytest.mark.parametrize("wpr,k,group", [
    (256, 4, 32),       # the served bank: one group of 32
    (256, 2591, 4),     # large k: the lists shrink the group
    (2048, 4, 16),      # int8 rows of D = 8192: 8 KB a query
    (2, 3000, 8),       # narrow rows, large k
    (256, 19000, 1),    # one query a block
])
def test_banded_plan_shrinks_the_group_to_fit(wpr, k, group):
    plan = plan_banded(70, 5000, wpr, k, 2, None, 132, 2, 232448)
    assert plan.group == group
    assert banded_smem(group, wpr, 2, k) <= 232448
    assert group == 32 or banded_smem(2 * group, wpr, 2, k) > 232448


def test_banded_plan_raises_where_no_block_fits():
    with pytest.raises(ValueError, match="banded block needs"):
        plan_banded(4, 100, 256, 30000, 1, None, 132, 2, 232448)
