"""The port's ``encode_search`` and ``encode_search_banded`` (CPU paths)
against the JAX package's ``encode_search_pallas`` and
``encode_search_banded_pallas`` (interpret mode on the CPU) and their
staged ``ref.py`` oracles, on the same codebooks, levels and banks.

Tolerance: exact (indices, scores, tie order, sentinel-masked slots).
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hd.encoding import encode_levels_batch as jencode
from repro.core.hd.similarity import bitpack_bipolar as jpack
from repro.kernels.encode_search import (
    encode_search_banded_pallas,
    encode_search_pallas,
)
from repro.kernels.encode_search import encode_search_ref as jref
from repro.kernels.encode_search.ref import encode_search_banded_ref as jbref
from repro_torch.convert import bank_rows_from_numpy, encoder_from_numpy
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_banded,
    encode_search_banded_plain,
    encode_search_plain,
    pack_codebook,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

CPU = "cpu"


def _inputs(rng, q, r, f, d, m, packed, dup):
    idh = rng.choice([-1, 1], size=(f, d)).astype(np.int8)
    lvh = rng.choice([-1, 1], size=(m, d)).astype(np.int8)
    levels = rng.integers(0, m, size=(q, f)).astype(np.int32)
    levels[:, rng.random(f) < 0.5] = 0
    levels[0] = 0                               # an empty spectrum
    if dup:   # the queries' own HVs, three times: every repeat ties
        hv = np.asarray(jencode(jnp.asarray(levels), jnp.asarray(idh),
                                jnp.asarray(lvh)))
        extra = rng.choice([-1, 1], size=(max(0, r - q), d)).astype(np.int8)
        base = np.concatenate([hv, extra])[:r]
        bank_hv = np.concatenate([base, base, base])
    else:
        bank_hv = rng.choice([-1, 1], size=(r, d)).astype(np.int8)
    bank = np.asarray(jpack(jnp.asarray(bank_hv))) if packed else bank_hv
    return idh, lvh, levels, bank


# (Q, R, F, D, m, packed, k, num_valid, duplicate rows)
CASES = [
    (3, 130, 20, 64, 5, True, 4, None, False),     # ragged R
    (5, 150, 31, 32, 4, True, 6, 100, False),      # num_valid < R
    (4, 40, 12, 64, 3, True, 7, 3, False),         # k > num_valid
    (2, 19, 9, 32, 4, True, 19, None, False),      # k = R
    (4, 12, 16, 32, 4, True, 10, None, True),      # ties (3 x 12 rows)
    (3, 60, 11, 40, 4, False, 5, None, False),     # int8, D % 32 != 0
    (3, 13, 10, 100, 6, False, 39, 30, True),      # int8, k = R, ties, masked
]


@pytest.mark.parametrize("Q,R,F,D,m,packed,k,nv,dup", CASES)
def test_encode_search_matches_reference(Q, R, F, D, m, packed, k, nv, dup):
    rng = np.random.default_rng(Q * 31 + R + F + D)
    idh, lvh, levels, bank = _inputs(rng, Q, R, F, D, m, packed, dup)
    ji, jv = encode_search_pallas(jnp.asarray(levels), jnp.asarray(idh),
                                  jnp.asarray(lvh), jnp.asarray(bank), dim=D,
                                  k=k, num_valid=nv)
    oi, ov = jref(jnp.asarray(levels), jnp.asarray(idh), jnp.asarray(lvh),
                  jnp.asarray(bank), k=k, num_valid=nv)
    enc = encoder_from_numpy(idh, lvh, device=CPU)
    r = bank_rows_from_numpy(bank, device=CPU)
    lv = torch.from_numpy(levels)
    got = encode_search(lv, enc.id_hvs, enc.level_hvs, r, dim=D, k=k,
                        num_valid=nv)
    for want_i, want_v in ((ji, jv), (oi, ov)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_v))


@pytest.mark.parametrize("d", [32, 40, 100])
def test_pack_codebook_pads_with_zero_bits(d):
    rng = np.random.default_rng(d)
    hv = torch.from_numpy(rng.choice([-1, 1], size=(7, d)).astype(np.int8))
    words = pack_codebook(hv)
    assert words.shape == (7, -(-d // 32))
    bits = np.unpackbits(words.numpy().view(np.uint8), axis=-1,
                         bitorder="little")
    np.testing.assert_array_equal(np.where(bits[:, :d] > 0, 1, -1),
                                  hv.numpy())
    assert not bits[:, d:].any()


def test_plain_is_the_cpu_path_and_counts_no_launch():
    rng = np.random.default_rng(2)
    idh, lvh, levels, bank = _inputs(rng, 3, 30, 8, 32, 4, True, False)
    args = (torch.from_numpy(levels), torch.from_numpy(idh),
            torch.from_numpy(lvh), bank_rows_from_numpy(bank, device=CPU))
    before = encode_search.launches
    a = encode_search(*args, dim=32, k=3)
    b = encode_search_plain(*args, dim=32, k=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert encode_search.launches == before


@pytest.mark.parametrize("bad", ["k0", "width", "dtype", "features"])
def test_wrapper_rejects_bad_operands(bad):
    levels = torch.zeros((2, 4), dtype=torch.int32)
    idh = torch.ones((4, 64), dtype=torch.int8)
    lvh = torch.ones((3, 64), dtype=torch.int8)
    r = torch.zeros((5, 2), dtype=torch.int32)
    k = 0 if bad == "k0" else 2
    if bad == "width":
        r = torch.zeros((5, 3), dtype=torch.int32)
    if bad == "dtype":
        r = r.to(torch.int64)
    if bad == "features":
        levels = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        encode_search(levels, idh, lvh, r, dim=64, k=k)


def test_levels_past_the_codebook_follow_the_staged_oracle():
    """A level >= m reads LV[m-1], as ``encode_levels_batch``'s clamped
    gather does (the reference's own Pallas kernel drops such bins
    instead; ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    f, d, m = 16, 64, 4
    idh, lvh, levels, bank = _inputs(rng, 6, 40, f, d, m, True, False)
    levels[:, :5] = m + 2
    oi, ov = jref(jnp.asarray(levels), jnp.asarray(idh), jnp.asarray(lvh),
                  jnp.asarray(bank), k=3)
    gi, gv = encode_search(torch.from_numpy(levels), torch.from_numpy(idh),
                           torch.from_numpy(lvh),
                           bank_rows_from_numpy(bank, device=CPU), dim=d, k=3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(oi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(ov))


# (Q, R, F, D, m, packed, k, num_valid, duplicate rows, num_tiles)
BANDED_CASES = [
    (7, 300, 20, 64, 5, True, 4, None, False, None),    # ragged Q and R
    (9, 260, 16, 32, 4, True, 5, 200, False, 2),        # num_valid, tight budget
    (4, 12, 16, 32, 4, True, 10, None, True, None),     # ties, bands < k
    (5, 90, 11, 40, 4, False, 5, None, False, None),    # int8, D % 32 != 0
]


@pytest.mark.parametrize("Q,R,F,D,m,packed,k,nv,dup,nt", BANDED_CASES)
def test_encode_search_banded_matches_reference(Q, R, F, D, m, packed, k, nv,
                                                dup, nt):
    rng = np.random.default_rng(Q * 17 + R + F + D)
    idh, lvh, levels, bank = _inputs(rng, Q, R, F, D, m, packed, dup)
    rows = bank.shape[0]
    if nt is None:
        starts = rng.integers(-2, rows, Q).astype(np.int32)
        lens = rng.integers(0, rows // 2 + 1, Q).astype(np.int32)
        lens[0] = 0                                  # an empty band
    else:  # every band inside the 2-tile budget of its 8-query block
        starts = rng.integers(100, 130, Q).astype(np.int32)
        lens = rng.integers(0, 120, Q).astype(np.int32)
    ji, jv = encode_search_banded_pallas(
        jnp.asarray(levels), jnp.asarray(idh), jnp.asarray(lvh),
        jnp.asarray(bank), jnp.asarray(starts), jnp.asarray(lens), dim=D,
        k=k, num_valid=nv, num_tiles=nt)
    oi, ov = jbref(jnp.asarray(levels), jnp.asarray(idh), jnp.asarray(lvh),
                   jnp.asarray(bank), starts, lens, k=k, num_valid=nv)
    enc = encoder_from_numpy(idh, lvh, device=CPU)
    got = encode_search_banded(
        torch.from_numpy(levels), enc.id_hvs, enc.level_hvs,
        bank_rows_from_numpy(bank, device=CPU), torch.from_numpy(starts),
        torch.from_numpy(lens), dim=D, k=k, num_valid=nv, num_tiles=nt)
    for want_i, want_v in ((ji, jv), (oi, ov)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_v))


def test_banded_plain_is_the_cpu_path_and_counts_no_launch():
    rng = np.random.default_rng(4)
    idh, lvh, levels, bank = _inputs(rng, 3, 30, 8, 32, 4, True, False)
    args = (torch.from_numpy(levels), torch.from_numpy(idh),
            torch.from_numpy(lvh), bank_rows_from_numpy(bank, device=CPU),
            torch.tensor([0, 5, 9], dtype=torch.int32),
            torch.tensor([10, 0, 21], dtype=torch.int32))
    before = encode_search_banded.launches
    a = encode_search_banded(*args, dim=32, k=3)
    b = encode_search_banded_plain(*args, dim=32, k=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert encode_search_banded.launches == before
