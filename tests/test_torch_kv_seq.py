"""The KV cache's sequence striped over ``kv_seq`` in one process: the
cache blocks against the reference's ``logical_to_spec``, and the
decode's partial attention and its combine against attention over the
whole cache, on the CPU.

- ``layers.kv_block`` and ``init_kv_cache`` under ``kv_seq="model"`` on
  the meshes (1, 2), (1, 4) and (2, 2) (a stand-in mesh with one rank's
  coordinates, every rank in turn) give each rank the block of
  ``("batch", "kv_seq", "kv_heads", None)`` that the reference's
  ``logical_to_spec`` places there: ``kv_seq`` takes ``model`` before the
  kv heads, which then replicate; a length that ``model`` does not divide
  falls back to the placement without ``kv_seq``.
- ``decode_attention_partial_plain`` on each block of a cut cache, and
  ``layers.combine_partials`` over the blocks, against
  ``decode_attention_plain`` on the whole cache: random cuts into 2-4
  blocks (blocks with no valid position, a block holding only slot 0,
  ``valid_len`` at and past each block's edge), rtol / atol 1e-5 (float32:
  the blocks' sums rescaled in another order). The float cache's
  ``layers.dense_partial`` the same way against its whole-cache value.
- The partial form's own edges: its output is ``decode_attention_plain``'s
  bit for bit, its log-sum-exp ``torch.logsumexp`` of the valid logits,
  and ``valid_len = 0`` gives zeros and ``-inf``.
- With ``kv_seq`` set and no mesh, a forced decode's logits and caches are
  those with the default rules, bit for bit.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.distributed.tensor import Shard

import _torch_kv_seq_mesh_ranks as R
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as JSH
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import train_step as JS
from repro_torch.configs import get_config
from repro_torch.dist import sharding as SH
from repro_torch.kernels.decode_attention import (
    decode_attention_partial,
    decode_attention_partial_plain,
    decode_attention_plain,
)
from repro_torch.models import layers as L

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = ((1, 2), (1, 4), (2, 2))
# full published widths: granite_20b's 48 heads over 1 kv head, qwen2_7b's
# 28 over 4; the reduced qwen2_7b's 4 over 2
ARCHS = {"granite_20b": get_config("granite_20b"),
         "qwen2_7b": get_config("qwen2_7b"),
         "qwen2_7b_reduced": get_config("qwen2_7b").reduced()}
# decode_32k's 32,768 slots; 30 (model = 2 divides it, 4 does not); 19
LENGTHS = (32_768, 30, 19)
BATCH = 8


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


def _stand_in(shape: tuple, coord: tuple):
    """A ``(data, model)`` mesh seen from the rank at ``coord``."""
    names = ("data", "model")

    class Mesh:
        mesh_dim_names = names
        mesh = torch.zeros(shape)

        def get_local_rank(self, axis):
            return coord[names.index(axis)]

    return Mesh()


def _block(entry, dim: int, sizes: dict, coord: dict) -> tuple[int, int]:
    """(first, length) of a rank's block of a dim by a spec entry."""
    if entry is None:
        return 0, dim
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    index, count = 0, 1
    for a in axes:
        index, count = index * sizes[a] + coord[a], count * sizes[a]
    return index * (dim // count), dim // count


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_blocks_are_the_references_spec(arch, mesh, length):
    cfg = ARCHS[arch]
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (BATCH, length, kv, hd)
    sizes = dict(zip(("data", "model"), mesh))
    want = tuple(JSH.logical_to_spec(
        L.CACHE_AXES, shape, types.SimpleNamespace(shape=sizes),
        JSH.ShardingRules().replace(kv_seq="model")))
    with SH.rules_override(kv_seq="model"):
        assert SH.logical_to_spec(L.CACHE_AXES, shape, sizes) == want
        striped = want[1] is not None
        # the model mesh dim's placement: the slots, or not them
        assert (SH.logical_to_sharding(L.CACHE_AXES, shape, sizes)[1]
                == Shard(1)) == striped
        if striped:
            # kv_seq claims model before kv_heads, which replicate
            assert want[1] == "model" and want[2] is None
        for d in range(mesh[0]):
            for m in range(mesh[1]):
                stub = _stand_in(mesh, (d, m))
                coord = {"data": d, "model": m}
                rows = _block(want[0], BATCH, sizes, coord)
                slots = _block(want[1], length, sizes, coord)
                got = L.kv_block(cfg, BATCH, stub, length)
                if striped:
                    assert got == (rows[1], 0, kv) + slots
                else:
                    # today's placement: the kv heads of the query heads
                    assert got == L.kv_block(cfg, BATCH, stub) + (0, length)
                cache = L.init_kv_cache(
                    dataclasses.replace(cfg, kv_quant_int8=True), BATCH,
                    length, device="meta", mesh=stub)
                assert cache.k.shape == (rows[1], slots[1], got[2], hd)
                assert cache.k_scale.shape == (rows[1], slots[1], got[2])
                assert cache.seq_block == (
                    (*slots, length, ("model",)) if striped else None)


def _stacked_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    """``combine_partials``' reduction over blocks stacked on dim 0."""
    r = t.amax(0, keepdim=True) if op == "max" else t.sum(0, keepdim=True)
    return r.expand_as(t).clone()


@st.composite
def cut_cache(draw):
    """(seed, B, KV, G, hd, S, block edges, valid_len)."""
    S = draw(st.integers(2, 48))
    n = draw(st.integers(2, min(4, S)))
    cuts = sorted(draw(st.sets(st.integers(1, S - 1), min_size=n - 1,
                               max_size=n - 1)))
    edges = [0, *cuts, S]
    near = sorted({1, S} | {e + d for e in edges for d in (0, 1)
                            if 1 <= e + d <= S})
    valid = draw(st.sampled_from(near))
    dims = (draw(st.integers(1, 2)), draw(st.integers(1, 2)),
            draw(st.integers(1, 3)), draw(st.sampled_from([16, 32])))
    return draw(st.integers(0, 2**31 - 1)), *dims, S, edges, valid


def _int8_case(seed, B, S, KV, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32) * hd ** -0.5
    k8 = rng.integers(-127, 128, (B, S, KV, hd), dtype=np.int8)
    v8 = rng.integers(-127, 128, (B, S, KV, hd), dtype=np.int8)
    ks = rng.uniform(0.005, 0.5, (B, S, KV)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, S, KV)).astype(np.float32)
    return [torch.from_numpy(a) for a in (q, k8, v8, ks, vs)]


def _combined(partial, edges, valid, *cache):
    """Each block's partial (the slots below ``valid`` in it), combined."""
    outs, lses = [], []
    for s0, s1 in zip(edges[:-1], edges[1:]):
        count = min(max(valid - s0, 0), s1 - s0)
        out, lse = partial(*(t[:, s0:s1] for t in cache), count)
        outs.append(out)
        lses.append(lse)
    return L.combine_partials(torch.stack(outs), torch.stack(lses),
                              _stacked_reduce)


@settings(deadline=None, max_examples=60)
@given(case=cut_cache())
def test_int8_blocks_combine_to_the_whole_cache(case):
    seed, B, KV, G, hd, S, edges, valid = case
    q, k8, v8, ks, vs = _int8_case(seed, B, S, KV, G, hd)
    got = _combined(lambda *a: decode_attention_partial_plain(q, *a),
                    edges, valid, k8, v8, ks, vs)
    want = decode_attention_plain(q, k8, v8, ks, vs, valid)
    assert torch.isfinite(got).all()
    for r in range(len(edges) - 1):
        torch.testing.assert_close(got[r], want, **TOL)


@settings(deadline=None, max_examples=60)
@given(case=cut_cache())
def test_float_blocks_combine_to_the_whole_cache(case):
    seed, B, KV, G, hd, S, edges, valid = case
    rng = np.random.default_rng(seed)
    qg = torch.from_numpy(rng.normal(size=(B, KV, G, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KV, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    got = _combined(lambda *a: L.dense_partial(qg, *a), edges, valid, k, v)
    want, _ = L.dense_partial(qg, k, v, valid)
    assert torch.isfinite(got).all()
    for r in range(len(edges) - 1):
        torch.testing.assert_close(got[r], want, **TOL)


@pytest.mark.parametrize("valid", [0, 1, 37, 64, 90])
def test_the_partial_form_is_the_plain_output_and_its_lse(valid):
    q, k8, v8, ks, vs = _int8_case(3, 2, 64, 2, 3, 32)
    out, lse = decode_attention_partial(q, k8, v8, ks, vs, valid)
    assert out.shape == q.shape and lse.shape == q.shape[:-1]
    if valid == 0:
        assert (out == 0).all() and (lse == float("-inf")).all()
        return
    torch.testing.assert_close(
        out, decode_attention_plain(q, k8, v8, ks, vs, valid), rtol=0,
        atol=0)
    logits = torch.einsum("bngk,bsnk->bngs", q, k8.float())
    logits = logits * ks.transpose(1, 2)[:, :, None, :]
    torch.testing.assert_close(
        lse, torch.logsumexp(logits[..., :min(valid, 64)], dim=-1), **TOL)


def test_a_lone_valid_block_is_its_own_attention():
    """Only the first block holds valid slots: the combine gives its own
    output (the empty blocks weigh exactly 0)."""
    q, k8, v8, ks, vs = _int8_case(5, 1, 24, 1, 4, 16)
    got = _combined(lambda *a: decode_attention_partial_plain(q, *a),
                    [0, 8, 16, 24], 5, k8, v8, ks, vs)
    want = decode_attention_plain(q, k8[:, :8], v8[:, :8], ks[:, :8],
                                  vs[:, :8], 5)
    torch.testing.assert_close(got[2], want, **TOL)


@pytest.mark.parametrize("kv", [False, True])
def test_kv_seq_without_a_mesh_changes_nothing(kv):
    state, _ = JS.init_train_state(jax_build_model(
        jax_get_config("qwen2_7b").reduced()), jax.random.PRNGKey(0))
    params = {"qwen": jax.tree.map(np.asarray, state.params)}
    base = R.serve(params, "qwen", kv, R.PROMPTS["qwen"])
    SH.set_mesh(None, R.KV_SEQ)
    got = R.serve(params, "qwen", kv, R.PROMPTS["qwen"])
    for a, b in zip(got["logits"], base["logits"], strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["blocks"], base["blocks"], strict=True):
        assert a["seq_block"] is None
        for f in ("k", "v"):
            np.testing.assert_array_equal(a[f], b[f])
