"""The plain reference against small cases worked by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import search as ref

INT32_MIN = -(2 ** 31)


def test_encode_by_hand():
    # F = 3 bins, D = 4, m = 3 levels
    id_hvs = torch.tensor([[1, 1, -1, -1], [1, -1, 1, -1], [-1, -1, -1, 1]],
                          dtype=torch.int8)
    level_hvs = torch.tensor([[1, 1, 1, 1], [1, 1, 1, -1], [-1, 1, 1, -1]],
                             dtype=torch.int8)
    levels = torch.tensor([[1, 2, 0],    # ID0*LV1 + ID1*LV2
                           [0, 0, 0],    # nothing present: every sign(0)
                           [2, 0, 5]],   # ID0*LV2 + ID2*LV2 (5 reads m-1)
                          dtype=torch.int8)
    # row 0: [1,1,-1,1] + [-1,-1,1,1] = [0,0,0,2] -> [-1,-1,-1,1]
    # row 2: [-1,1,-1,1] + [1,-1,-1,-1] = [0,0,-2,0] -> all -1
    want = torch.tensor([[-1, -1, -1, 1], [-1, -1, -1, -1],
                         [-1, -1, -1, -1]], dtype=torch.int8)
    assert torch.equal(ref.encode(levels, id_hvs, level_hvs, block=2), want)


def test_pack_words_bit_order():
    hv = -torch.ones((2, 64), dtype=torch.int8)
    hv[0, 0] = 1           # word 0, bit 0
    hv[0, 33] = 1          # word 1, bit 1
    hv[1, 31] = 1          # word 0, bit 31: the int32 sign bit
    got = ref.pack_words(hv)
    assert got.dtype == torch.int32
    assert got.tolist() == [[1, 2], [-(2 ** 31), 0]]


def test_cells_sum_adjacent_dimensions():
    hv = torch.tensor([[1, 1, -1, 1, -1, -1]], dtype=torch.int8)
    assert ref.cells(hv, 2).tolist() == [[2, 0, -2]]
    assert ref.cells(hv, 1) is hv


def test_sorted_positions_are_stable_per_block():
    dec = np.array([5.0, 1.0, 5.0], np.float32)
    tgt = np.array([3.0, 3.0, 2.0], np.float32)
    # decoys sort to rows 1, 0, 2; targets to 2, 0, 1 (after the 3 decoys)
    assert ref.sorted_positions(dec, tgt).tolist() == [1, 0, 2, 4, 5, 3]


def test_topk_ties_go_to_the_lower_stored_row():
    score = torch.tensor([[3, 7, 7, 1, 7]], dtype=torch.int32)
    rows, vals = ref.topk(score, 3, 8, torch.arange(5))
    assert rows.tolist() == [[1, 2, 4]] and vals.tolist() == [[7, 7, 7]]
    # stored positions reversed: row 4 is stored first
    rows, _ = ref.topk(score, 3, 8, torch.tensor([4, 3, 2, 1, 0]))
    assert rows.tolist() == [[4, 2, 1]]


def test_topk_fills_a_narrow_window_with_the_masked_rows():
    score = torch.tensor([[5, 6, 2, 8]], dtype=torch.int32)
    allowed = torch.tensor([[False, True, False, False]])
    rows, vals = ref.topk(score, 3, 8, torch.tensor([2, 0, 3, 1]), allowed)
    # row 1 in the window; then the masked rows by stored position: 3, 0
    assert rows.tolist() == [[1, 3, 0]]
    assert vals.tolist() == [[6, INT32_MIN, INT32_MIN]]


def test_window_bounds_are_strict():
    rows = torch.tensor([79.9, 80.0, 80.1, 119.9, 120.0], dtype=torch.float32)
    got = ref.window(rows, torch.tensor([100.0]), tol=20.0, open_tol=20.0)
    assert got.tolist() == [[False, False, True, True, False]]


def test_scores_are_exact_dot_products():
    g = torch.Generator().manual_seed(0)
    q = torch.randint(0, 2, (5, 64), generator=g, dtype=torch.int8) * 2 - 1
    b = torch.randint(0, 2, (13, 64), generator=g, dtype=torch.int8) * 2 - 1
    want = q.to(torch.int64) @ b.to(torch.int64).T
    assert torch.equal(ref.scores(q, b, block=5).to(torch.int64), want)


def test_fdr_by_hand():
    # 2 decoys (rows 0, 1), targets from row 2; one query's window empty
    rows = np.array([5, 0, 7, 9, 1])
    vals = np.array([10, 9, 9, 3, INT32_MIN])
    valid = np.array([True, True, True, True, False])
    is_t, acc, match = ref.fdr(rows, vals, 2, 0.5, valid)
    # by score: q0 (T), q1 (D), q2 (T; tied with q1, later in the batch),
    # q3 (T); decoys / targets run 0/1, 1/1, 1/2, 1/3, so the longest
    # prefix at or below 0.5 ends at q3 although q1 alone reads 1.0
    assert is_t.tolist() == [True, False, True, True, False]
    assert acc.tolist() == [True, False, True, True, False]
    assert match.tolist() == [3, -1, 5, 7, -1]
    _, acc, _ = ref.fdr(rows, vals, 2, 0.01, valid)
    assert acc.tolist() == [True, False, False, False, False]


@pytest.mark.parametrize("cell_bits", [1, 2])
def test_search_orders_and_windows(cell_bits):
    g = torch.Generator().manual_seed(1)
    bank = torch.randint(0, 2, (40, 32), generator=g, dtype=torch.int8) * 2 - 1
    q = bank[[3, 17]].clone()
    prec = torch.linspace(100.0, 500.0, 40)
    rows, vals, valid = ref.search(
        q, bank, 2, position=torch.arange(40), row_prec=prec,
        q_prec=torch.tensor([float(prec[3]), 1000.0]), tol=5.0,
        open_tol=30.0, cell_bits=cell_bits)
    assert valid.tolist() == [True, False]
    assert rows[0, 0] == 3
    assert vals[1].tolist() == [INT32_MIN, INT32_MIN]
    assert rows[1].tolist() == [0, 1]
