"""DB search over a device mesh, DTensor placements, the mesh builders and
the collective matmuls of the port, against the JAX package, on gloo
CPU ranks.

The ranks are processes started with ``spawn`` from
``tests/_torch_mesh_ranks.py`` (which imports no JAX), once a world size
(2 and 4), through a ``file://`` store under the test's temporary
directory; each builds every ``(data, model)`` mesh of its world size
((1, 2) and (2, 1) at 2 ranks, (2, 2) and (1, 4) at 4) and runs every
case on it. A run joins within ``JOIN_TIMEOUT_S`` or its children are
killed and the test fails.

* **Routes** (two libraries: 64-dim packed and 72-dim int8 banks; decoys
  tie targets; duplicate rows): ``search_database`` (unfused, fused),
  ``search_with_fdr``, ``search_database_levels`` (staged, fused e2e),
  ``sharded_topk_search(mesh=)``, the OMS plan and ``oms_search_encoded``,
  ``oms_search_levels`` and ``oms_search_with_fdr`` (narrow windows, so
  overflow slots, and empty windows), Q = 5 (not divisible by ``data``),
  and a ``BankRegistry(mesh=)`` behind a flush-sync server before and
  after an append (the merged base + delta routes). Every rank's result
  must equal, bit for bit (indices, scores, tie order, overflow slots,
  FDR masks), the reference's emulated-shard route with as many shards
  as the mesh's ``model`` axis (its shard_map routes fail under JAX 0.9
  here) and ``topk_search`` on the unsharded bank. A rank holds
  ``shard_rows`` rows; k > ``shard_rows`` and ``emulate_shards`` with a
  mesh raise as the reference does; a size-1 ``model`` axis takes the
  local route.
* **Placements**: each rank's ``to_local()`` block equals numpy slicing by
  the reference's ``logical_to_spec`` (read off a stand-in mesh with a
  ``shape`` dict); a tuple rule out of the mesh's order raises.
* **Collective matmuls**: within rtol 1e-5 of the reference function's
  ``x @ w``, bit for bit against a replay of the ring order from the
  ranks' own partials, ``x @ w`` for indivisible dims.
* **Launcher**: ``serve_db --reduced --fused --flush-ms 0`` on 2 ranks
  (batches are then the traffic's bursts, as in one process) serves the
  same results and identifications as one process, flush-sync and with
  ``--continuous`` (rank 0 plans each step; on the CPU every slot polls
  done, so the batches are one process's).
* **Continuous** (``DBSearchServer(continuous=True)`` over the mesh,
  after the append): its drain takes the flush-sync drain's batches, so
  it serves the flush-sync server's results and the reference's.
  ``tests/test_torch_continuous_mesh.py`` covers continuous serving over
  a mesh in full.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from repro.core.hd.encoding import HDEncoderConfig, make_codebooks
from repro.core.hd.encoding import encode_levels_batch as jencode
from repro.dist import sharding as JSH
from repro.launch import mesh as jmesh
from repro.serve import BankRegistry as JRegistry
from repro.serve import DBSearchServer as JServer
from repro.serve import QueryEncoder as JEncoder
from repro.serve import db_search as J
from repro.serve import oms as joms
from repro_torch.core.hd.similarity import topk_search
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import serve_db
from repro_torch.serve import sharded_topk_search

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 120
WORLDS = (2, 4)
MESHES = [(w, s) for w in WORLDS for s in R.MESHES[w]]
MESH_IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in MESHES]
F, LEVELS = 48, 8
LIBS = {"packed": 64, "int8": 72}
JCFG = joms.OMSConfig(**R.CFG)
LAUNCHER = ["--reduced", "--device", "cpu", "--fused", "--flush-ms", "0",
            "--queries", "48"]


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


def _library(seed: int, d: int) -> dict:
    """The reference's codebooks and the HVs they encode: 90 targets
    (duplicate rows), decoys (some tying targets), 12 queries (half copy a
    target's levels at its precursor + 40, two with empty windows), and
    an append of 6 targets and 3 decoys (one tying a base target)."""
    rng = np.random.default_rng(seed)
    idh, lvh = (np.asarray(a) for a in make_codebooks(HDEncoderConfig(
        dim=d, num_features=F, num_levels=LEVELS, seed=seed)))

    def encode(lev):
        return np.asarray(jencode(jnp.asarray(lev), jnp.asarray(idh),
                                  jnp.asarray(lvh)))

    n, nq = 90, 12
    lev = rng.integers(0, LEVELS, size=(n, F)).astype(np.int32)
    lev[rng.random(lev.shape) < 0.6] = 0
    lev[n // 2:] = lev[: n - n // 2]
    refs = encode(lev)
    decoys = -refs
    decoys[:10] = refs[:10]
    prec = rng.uniform(400, 1600, n).astype(np.float32)
    prec[n // 2:] = prec[: n - n // 2]
    q_lev = rng.integers(0, LEVELS, size=(nq, F)).astype(np.int32)
    q_lev[rng.random(q_lev.shape) < 0.6] = 0
    qprec = rng.uniform(420, 1650, nq).astype(np.float32)
    pick = rng.integers(0, n, size=nq // 2)
    q_lev[: nq // 2] = lev[pick]
    qprec[: nq // 2] = prec[pick] + 40.0
    qprec[-2:] = 1e6
    refs1 = rng.choice([-1, 1], size=(6, d)).astype(np.int8)
    refs1[0] = refs[3]
    dec1 = rng.choice([-1, 1], size=(3, d)).astype(np.int8)
    prec1 = rng.uniform(400, 1600, 6).astype(np.float32)
    prec1[0] = prec[3]
    return dict(idh=idh, lvh=lvh, refs=refs, decoys=decoys, prec=prec,
                q_lev=q_lev, q_hv=encode(q_lev), qprec=qprec, refs1=refs1,
                dec1=dec1, prec1=prec1)


def _inputs() -> dict:
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 12)).astype(np.float32)
    w = rng.normal(size=(12, 8)).astype(np.float32)
    return {"libs": {name: _library(10 + d, d) for name, d in LIBS.items()},
            "full": np.arange(96, dtype=np.float32).reshape(12, 8),
            "matmul": (x, w, rng.normal(size=(8, 7)).astype(np.float32))}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    """``ranks(world)``: the spawned ranks' results (run once a world)."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = R.spawn(
                R.worker, world, tmp_path_factory.mktemp(f"mesh{world}"),
                dict(inputs, launcher=LAUNCHER if world == 2 else None),
                JOIN_TIMEOUT_S)
        return runs[world]
    return get


# -------------------------------------------------- the reference's side --

def _jdb(lib, n, **kw):
    return J.shard_database(jnp.asarray(lib["refs"]),
                            decoys=jnp.asarray(lib["decoys"]),
                            emulate_shards=n if n > 1 else None, **kw)


def _pair(pair):
    return tuple(np.asarray(a) for a in pair)


def _jfdr(res):
    return {name: None if getattr(res, name) is None
            else np.asarray(getattr(res, name)) for name in (
                "indices", "scores", "is_target", "accept", "match",
                "valid")}


def _jdrain(server, queries, prec=None):
    rids = [server.submit(q, tenant="a",
                          precursor=None if prec is None else float(prec[i]))
            for i, q in enumerate(queries)]
    done = {r.rid: r for r in server.run_until_drained()}
    return [(np.asarray(r.indices), np.asarray(r.scores), bool(r.is_target),
             bool(r.accept), int(r.match), bool(r.has_candidate))
            for r in (done[rid].result for rid in rids)]


def _reference(lib: dict, n: int) -> dict:
    """The reference's emulated-shard routes over ``n`` shards, keyed as
    the ranks key theirs (their fused and unfused routes both against
    the reference's one)."""
    q = jnp.asarray(lib["q_hv"])
    lev = jnp.asarray(lib["q_lev"])
    enc = JEncoder(id_hvs=jnp.asarray(lib["idh"]),
                   level_hvs=jnp.asarray(lib["lvh"]))
    k = R.K
    out = {}
    db = _jdb(lib, n)
    odb = _jdb(lib, n, precursor=lib["prec"])
    plan = J.oms_plan(odb, lib["qprec"], JCFG)
    rplan = J.oms_plan(odb, lib["qprec"][:5], JCFG)
    base = {
        "exact": _pair(J.search_database(db, q, k)),
        "exact_ragged": _pair(J.search_database(db, q[:5], k)),
        "fdr": _jfdr(J.search_with_fdr(db, q, k, 0.5)),
        "topk": _pair(J.sharded_topk_search(q, jnp.asarray(lib["refs"]), k,
                                            num_shards=n)),
        "oms_plan": (plan.starts, plan.lens, plan.num_tiles),
        "oms": _pair(J.oms_search_encoded(odb, J.encode_queries(odb, q),
                                          plan, k)),
        "oms_fdr": _jfdr(J.oms_search_with_fdr(odb, q, lib["qprec"], k,
                                               0.5, JCFG)),
        "oms_ragged": _pair(J.oms_search_encoded(
            odb, J.encode_queries(odb, q[:5]), rplan, k)),
    }
    levels = _pair(J.search_database_levels(db, enc, lev, k))
    oms_levels = _pair(J.oms_search_levels(odb, enc, lev, plan, k))
    for fused in (False, True):
        for key, val in base.items():
            out[f"{key}_fused{fused}"] = val
        for e2e in (False, True):
            out[f"levels_fused{fused}_e2e{e2e}"] = levels
            out[f"oms_levels_fused{fused}_e2e{e2e}"] = oms_levels
    for oms in (False, True):
        reg = JRegistry(emulate_shards=n if n > 1 else None)
        reg.register("a", jnp.asarray(lib["refs"]),
                     decoys=jnp.asarray(lib["decoys"]),
                     precursor=lib["prec"] if oms else None)
        srv = JServer(reg, oms=JCFG if oms else None, **R.SERVER)
        qp = lib["qprec"] if oms else None
        before = _jdrain(srv, list(lib["q_hv"]), qp)
        srv.append("a", lib["refs1"], lib["dec1"],
                   precursor=lib["prec1"] if oms else None,
                   decoy_precursor=lib["prec1"][:3] if oms else None)
        out[f"server_oms{oms}"] = (before, _jdrain(srv, list(lib["q_hv"]),
                                                   qp))
    return out


@pytest.fixture(scope="module")
def reference(inputs):
    """``reference(lib, n)``: the reference's routes (computed once)."""
    runs = {}

    def get(name, n):
        if (name, n) not in runs:
            runs[name, n] = _reference(inputs["libs"][name], n)
        return runs[name, n]
    return get


def _equal(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for key in want:
            _equal(got[key], want[key], f"{what}.{key}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)


ROUTE_KEYS = [f"{r}_fused{f}" for r in ("exact", "exact_ragged", "fdr",
                                        "topk", "oms_plan", "oms", "oms_fdr",
                                        "oms_ragged")
              for f in (False, True)] + [
    f"{r}_fused{f}_e2e{e}" for r in ("levels", "oms_levels")
    for f in (False, True) for e in (False, True)] + [
    "server_omsFalse", "server_omsTrue"]


@pytest.mark.parametrize("key", ROUTE_KEYS)
@pytest.mark.parametrize("lib", list(LIBS))
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_mesh_route_matches_the_reference_emulated_route(
        ranks, reference, world, shape, lib, key):
    want = reference(lib, shape[1])[key]
    for r, res in enumerate(ranks(world)):
        _equal(res[shape]["routes"][lib][key], want,
               f"rank {r} {shape} {lib} {key}")


EXACT_KEYS = [f"{r}_fused{f}" for r in ("exact", "topk")
              for f in (False, True)] + [
    f"levels_fused{f}_e2e{e}" for f in (False, True) for e in (False, True)]


@pytest.mark.parametrize("key", EXACT_KEYS)
@pytest.mark.parametrize("lib", list(LIBS))
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_mesh_route_matches_topk_search_on_the_whole_bank(
        ranks, inputs, world, shape, lib, key):
    L = inputs["libs"][lib]
    if key.startswith("topk"):
        bank = L["refs"]
    else:
        bank = np.concatenate([L["decoys"], L["refs"]])
    wi, wv = topk_search(torch.from_numpy(L["q_hv"]), torch.from_numpy(bank),
                         R.K)
    for res in ranks(world):
        gi, gv = res[shape]["routes"][lib][key]
        np.testing.assert_array_equal(gi, wi.numpy())
        np.testing.assert_array_equal(gv, wv.numpy())


@pytest.mark.parametrize("lib", list(LIBS))
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_each_rank_holds_its_own_block(ranks, inputs, world, shape, lib):
    L = inputs["libs"][lib]
    rows = len(L["refs"]) + len(L["decoys"])
    model = shape[1]
    for res in ranks(world):
        got = res[shape]["routes"][lib]
        assert got["num_shards"] == model
        assert got["on_mesh"] == (model > 1)       # size 1: the local route
        assert got["rows_held"] == -(-rows // model)
        assert got["delta_device_omsFalse"] == "cpu"


@pytest.mark.parametrize("lib", list(LIBS))
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_mesh_edge_cases_raise_as_the_reference(ranks, inputs, reference,
                                                world, shape, lib):
    L = inputs["libs"][lib]
    n = shape[1]
    jdb = _jdb(L, n)
    with pytest.raises(ValueError, match="shard_rows" if n > 1 else "k="):
        J.search_database(jdb, jnp.asarray(L["q_hv"]), jdb.shard_rows + 1)
    for res in ranks(world):
        got = res[shape]["routes"][lib]
        assert got["k_over_shard_rows"] == (jdb.shard_rows, "ValueError")
        # emulate_shards with a sharded axis: the reference raises too
        assert got["emulate_with_mesh"] == ("ValueError" if n > 1
                                            else "none")
        assert got["not_a_mesh"] == "TypeError"
        # continuous mode serves over the mesh: its drain takes the
        # flush-sync drain's batches, so the results (FDR too) are the
        # flush-sync server's after the append, and the reference's
        for oms in (False, True):
            _equal(got[f"continuous_oms{oms}"],
                   got[f"server_oms{oms}"][1], f"continuous oms={oms}")
            _equal(got[f"continuous_oms{oms}"],
                   reference(lib, n)[f"server_oms{oms}"][1],
                   f"continuous vs the reference oms={oms}")


def test_ragged_queries_skip_the_data_split(ranks):
    """Q = 5 on a 2-way data axis is not split (every data row runs all
    five), and the results still equal the reference's."""
    for res in ranks(4):
        assert res[(2, 2)]["coords"]["data"] in (0, 1)
        assert res[(2, 2)]["routes"]["packed"]["exact_ragged_fusedTrue"][
            0].shape == (5, R.K)


def test_the_reference_overflow_and_empty_windows_are_exercised(reference):
    want = reference("packed", 2)
    assert (want["oms_fusedTrue"][1] == np.iinfo(np.int32).min).any()
    assert not want["oms_fdr_fusedTrue"]["valid"].all()


def test_size_one_axes_take_the_local_route():
    refs = torch.ones((8, 32), dtype=torch.int8)
    got = sharded_topk_search(refs[:2], refs, 2, mesh={"data": 1, "model": 1})
    want = topk_search(refs[:2], refs, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="no process group"):
        sharded_topk_search(refs[:2], refs, 2, mesh={"model": 2})


# ------------------------------------------------------------ placements --

def _spec_block(full, spec, coords, sizes):
    """Numpy slicing by a PartitionSpec (GSPMD's block order: a tuple's
    first axis is the major one)."""
    idx = []
    for d, entry in enumerate(tuple(spec) + (None,) * (full.ndim - len(
            spec))):
        if entry is None:
            idx.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        block, count = 0, 1
        for a in axes:
            block = block * sizes[a] + coords[a]
            count *= sizes[a]
        n = full.shape[d] // count
        idx.append(slice(block * n, (block + 1) * n))
    return full[tuple(idx)]


@pytest.mark.parametrize("case", R.PLACEMENTS, ids=lambda c: c[0])
@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_placements_slice_as_the_reference_spec(ranks, inputs, world, shape,
                                                case):
    name, axes, dims, rules = case
    sizes = dict(zip(R.NAMES, shape))
    stand_in = types.SimpleNamespace(shape=sizes)
    spec = JSH.logical_to_spec(axes, dims, stand_in,
                               JSH.DEFAULT_RULES.replace(**rules))
    full = inputs["full"][:dims[0], :dims[1]]
    picked = [e for e in spec if isinstance(e, tuple)]
    out_of_order = any(list(e) != sorted(e, key=R.NAMES.index)
                       for e in picked)
    for res in ranks(world):
        got = res[shape]["placements"][name]
        if out_of_order:
            assert got[0] == "ValueError" and "mesh's order" in got[1]
            continue
        want = _spec_block(full, spec, res[shape]["coords"], sizes)
        np.testing.assert_array_equal(got[1], want)


def test_the_out_of_order_rule_raises_where_it_shards_two_axes():
    spec = JSH.logical_to_spec(("batch", None), (8, 3),
                               types.SimpleNamespace(shape={"data": 2,
                                                            "model": 2}),
                               JSH.DEFAULT_RULES.replace(
                                   batch=("model", "data")))
    assert tuple(spec) == (("model", "data"), None)
    with pytest.raises(ValueError, match="mesh's order"):
        SH.logical_to_sharding(("batch", None), (8, 3),
                               {"data": 2, "model": 2},
                               SH.DEFAULT_RULES.replace(
                                   batch=("model", "data")))


@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_constrain_redistributes_a_dtensor(ranks, inputs, world, shape):
    sizes = dict(zip(R.NAMES, shape))
    spec = JSH.logical_to_spec(("batch", "heads"), (8, 4),
                               types.SimpleNamespace(shape=sizes))
    full = inputs["full"][:8, :4]
    for res in ranks(world):
        placements, local, whole, plain_kept = res[shape]["placements"][
            "constrain"]
        np.testing.assert_array_equal(local, _spec_block(
            full, spec, res[shape]["coords"], sizes))
        np.testing.assert_array_equal(whole, full)
        assert plain_kept


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.ones(4, 2)
    assert SH.constrain(x, "batch", None) is x
    SH.set_mesh({"data": 2, "model": 1})
    assert SH.constrain(x, "batch", None) is x


@pytest.mark.parametrize("value", [None, "0", "1", "yes"])
def test_baseline_mode_matches_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("REPRO_BASELINE", raising=False)
    else:
        monkeypatch.setenv("REPRO_BASELINE", value)
    assert SH.baseline_mode() == JSH.baseline_mode()


def test_tree_shardings_maps_nested_trees():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"data": 2, "model": 2}
    axes = {"w": ("fsdp", "ff"), "b": [("ff",), (None,)],
            "t": (("batch", None),)}
    shapes = {"w": torch.zeros(4, 8), "b": [(6,), (5,)],
              "t": (torch.Size([8, 3]),)}
    got = SH.tree_shardings(axes, shapes, mesh)
    assert got["w"] == (Shard(0), Shard(1))
    assert got["b"] == [(Replicate(), Shard(0)), (Replicate(), Replicate())]
    assert got["t"] == ((Shard(0), Replicate()),)


# ------------------------------------------------------------ mesh shapes --

@pytest.mark.parametrize("n", range(1, 9))
def test_debug_mesh_factorization_matches_the_reference(monkeypatch, n):
    made = []
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: made.append((shape, axes)))
    jmesh.make_debug_mesh(n)
    assert made == [(M.debug_mesh_shape(n), ("data", "model"))]


def test_debug_mesh_without_a_group():
    assert M.make_debug_mesh() == {"data": 1, "model": 1}
    assert M.make_debug_mesh(1) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="process group"):
        M.make_debug_mesh(4)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_at_world_size_one(multi_pod, tmp_path):
    import torch.distributed as dist

    with pytest.raises(ValueError, match="no process group"):
        M.make_production_mesh(multi_pod=multi_pod)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match=r"needs (256|512) ranks"):
            M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        mesh = M.make_debug_mesh(device_type="cpu")
        assert SH.mesh_shape(mesh) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", WORLDS)
def test_debug_mesh_over_the_ranks(ranks, world):
    for res in ranks(world):
        assert res["debug_mesh"] == dict(zip(("data", "model"),
                                             M.debug_mesh_shape(world)))


# ---------------------------------------------------- collective matmuls --

@pytest.mark.parametrize("world,shape", MESHES, ids=MESH_IDS)
def test_collective_matmuls_match_the_reference(ranks, inputs, world, shape):
    import jax
    from repro.dist import collective_matmul as JCM

    x, w, x_odd = inputs["matmul"]
    res = [r[shape]["matmuls"] for r in ranks(world)]
    n = shape[1]
    one = jax.make_mesh((1,), ("model",))
    want = np.asarray(JCM.ring_matmul_reduce(jnp.asarray(x), jnp.asarray(w),
                                             one))
    want_ag = np.asarray(JCM.ag_matmul_pipelined(jnp.asarray(x),
                                                 jnp.asarray(w), one))
    partials = {got["coord"]: got["ring_partial"] for got in res}
    columns = {got["coord"]: np.concatenate(got["ag_blocks"]) for got in res}
    replay_ag = np.concatenate([columns[c] for c in range(n)], axis=1)
    for got in res:
        np.testing.assert_allclose(got["ring"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["ag"], want_ag, rtol=1e-5, atol=1e-6)
        # the ring's order: rank c adds its partial, then c-1's, c-2's, ...
        c = got["coord"]
        acc = partials[c]
        for t in range(1, n):
            acc = acc + partials[(c - t) % n]
        np.testing.assert_array_equal(got["ring"], acc)
        np.testing.assert_array_equal(got["ag"], replay_ag)
        # indivisible dims fall back to x @ w
        np.testing.assert_array_equal(got["ring_odd"], got["ring_odd_want"])
        np.testing.assert_array_equal(got["ag_odd"], got["ag_odd_want"])


def test_collective_matmuls_fall_back_without_a_mesh():
    from repro_torch.dist.collective_matmul import (
        ag_matmul_pipelined,
        ring_matmul_reduce,
    )
    x, w = torch.randn(4, 6), torch.randn(6, 2)
    for fn in (ring_matmul_reduce, ag_matmul_pipelined):
        assert torch.equal(fn(x, w, None), x @ w)
        assert torch.equal(fn(x, w, {"model": 1}), x @ w)


# ---------------------------------------------------------------- launcher --

def test_launcher_on_two_ranks_matches_one_process(ranks, capsys):
    want = serve_db.main(LAUNCHER)
    assert "mesh: {'data': 1, 'model': 1}" in capsys.readouterr().out
    cont = serve_db.main(LAUNCHER + ["--continuous"])
    for res in ranks(2):
        got = res["launcher"]["flush"]
        assert (got["identified"], got["correct"], got["count"]) == (
            want["identified"], want["correct"], want["count"])
        # continuous mode serves over the mesh as in one process
        got = res["launcher"]["continuous"]
        assert (got["identified"], got["correct"], got["count"]) == (
            cont["identified"], cont["correct"], cont["count"])


def test_launcher_results_equal_one_process_request_by_request(ranks):
    one = R._Recording
    for mode, extra in (("flush", []), ("continuous", ["--continuous"])):
        one.done = []
        serve_db.main(LAUNCHER + extra, executor_cls=one)
        want = R._results(one.done)
        for res in ranks(2):
            _equal(res["launcher"][mode]["results"], want,
                   f"launcher {mode}")
