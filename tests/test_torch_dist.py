"""Parity of the port's ``dist`` modules (``sharding``'s pure half,
``compression``, ``straggler.HeartbeatRegistry``) with the JAX package,
and the process-group routes on gloo CPU ranks, on the CPU.

The same numpy inputs go through ``repro.dist`` and ``repro_torch.dist``:
``logical_to_spec`` over drawn axes, shapes and mesh shapes (a stub mesh
whose ``.shape`` is a dict on the reference side, the dict itself on the
port's), the rules helpers, the top-k mask with planted ties and zeros,
every ``dcn_send`` method, the wire-byte counts, and the heartbeats: all
bit for bit. ``jax.random`` cannot be reproduced in torch, so the int8
comparisons pass the reference's own uniforms (``fold_in(key, i)`` a
leaf) into the port, and the port's own draws are held to the
invariants the reference states (``tests/test_compression_props.py``):
unbiased over keys, within one scale step, the same key the same draws,
another step, pod or leaf other draws. ``dcn_allreduce_tree`` and
``cross_pod_allreduce`` are held, with no mesh and on a 1-rank gloo
group, against the reference's own calls on ``jax.make_mesh((1,),
("pod",))``.

The process-group train step and the collectives run on 2 and 4 gloo
ranks, each a process started with ``spawn`` from
``tests/_torch_dist_ranks.py`` (which imports no JAX) through a
``file://`` store under the test's temporary directory, and are held
against the port's emulated route in this process: bit for bit at 2
ranks. At 4 ranks the port's ``all_reduce`` sums in gloo's order, not the
emulated route's pod order, so the sums differ in the last bits: after 3
steps the loss is held within rtol 1e-6, the grad norm within rtol 1e-5
and the parameters within rtol 1e-5 / atol 2e-6; each rank's residual row
after one step (before any sum reaches it) bit for bit; the collectives
within rtol / atol 1e-6. Every multi-rank run joins within
``JOIN_TIMEOUT_S`` or its children are killed and the test fails.
"""

import multiprocessing
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_dist_ranks as R
from repro.dist import compression as JC
from repro.dist import sharding as JSH
from repro.dist.straggler import HeartbeatRegistry as JaxHeartbeatRegistry
from repro_torch.dist import compression as C
from repro_torch.dist import sharding as SH
from repro_torch.dist.straggler import HeartbeatRegistry

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 120
METHODS = ("none", "int8", "topk", "topk_ef")


@pytest.fixture(autouse=True)
def no_global_mesh():
    JSH.set_mesh(None)
    SH.set_mesh(None)
    yield
    SH.set_mesh(None)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    return np.asarray(x)


# -------------------------------------------------------------- sharding --

MESH_AXES = ("pod", "data", "model")
LOGICAL = tuple(f.name for f in JSH.ShardingRules.__dataclass_fields__
                .values())


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 10**9), st.sampled_from(["default", "fsdp_only"]))
def test_logical_to_spec_matches(seed, preset):
    rng = np.random.default_rng(seed)
    sizes = {a: int(rng.choice([1, 2, 3, 4])) for a in MESH_AXES
             if rng.random() < 0.8}
    ndim = int(rng.integers(1, 5))
    axes = tuple(None if rng.random() < 0.2 else str(rng.choice(LOGICAL))
                 for _ in range(ndim))
    shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16]))
                  for _ in range(ndim))
    want = JSH.logical_to_spec(axes, shape,
                               types.SimpleNamespace(shape=dict(sizes)),
                               JSH.RULE_PRESETS[preset])
    got = SH.logical_to_spec(axes, shape, sizes, SH.RULE_PRESETS[preset])
    assert got == tuple(want), (axes, shape, sizes)


def test_logical_to_spec_reads_the_installed_rules():
    SH.set_mesh({"pod": 2, "data": 2}, SH.RULE_PRESETS["fsdp_only"])
    assert SH.get_rules() is SH.RULE_PRESETS["fsdp_only"]
    assert SH.logical_to_spec(("batch", "fsdp", "heads"), (4, 6, 4),
                              SH.get_mesh()) == (("pod", "data"), None, None)
    SH.set_mesh(None)
    assert SH.get_mesh() is None and SH.get_rules() is SH.DEFAULT_RULES


def test_rules_and_presets_match():
    assert SH.ShardingRules.__dataclass_fields__.keys() == \
        JSH.ShardingRules.__dataclass_fields__.keys()
    for name in JSH.RULE_PRESETS:
        want, got = JSH.RULE_PRESETS[name], SH.RULE_PRESETS[name]
        assert {f: getattr(got, f) for f in LOGICAL} == \
            {f: getattr(want, f) for f in LOGICAL}
    assert SH.DEFAULT_RULES.replace(kv_seq="model").kv_seq == "model"
    assert SH.DEFAULT_RULES.kv_seq is None
    with pytest.raises(AttributeError):
        SH.DEFAULT_RULES.lookup("not_an_axis")


@pytest.mark.parametrize("rule,axis", [
    (None, "pod"), ("pod", "pod"), ("data", "pod"), (("pod", "data"), "pod"),
    (("pod",), "pod"), (("data", "model"), "pod"), (("pod", "data"), "data"),
])
def test_without_axis_matches(rule, axis):
    assert SH.without_axis(rule, axis) == JSH.without_axis(rule, axis)


def test_rules_override_scoping_matches():
    for S in (JSH, SH):
        S.set_mesh(None)
        base = S.get_rules()
        with S.rules_override(batch=S.without_axis(base.batch, "pod")) as r:
            assert r.batch == ("data",) and S.get_rules() is r
            with S.rules_override(ff=None):
                assert S.get_rules().ff is None
                assert S.get_rules().batch == ("data",)
            assert S.get_rules().ff == "model"
        assert S.get_rules() is base
        with pytest.raises(RuntimeError):
            with S.rules_override(vocab=None):
                raise RuntimeError("inside")
        assert S.get_rules() is base


@pytest.mark.parametrize("shape", [None, {}, {"data": 4}, {"pod": 1},
                                   {"pod": 2, "data": 4}, {"pod": 8}])
def test_pod_axis_size_matches(shape):
    ref = None if shape is None else types.SimpleNamespace(shape=shape)
    assert SH.pod_axis_size(shape) == JSH.pod_axis_size(ref)


@pytest.mark.parametrize("x", [("batch", None), (), (None,), "batch",
                               ("a", 1), [("b",)], ("heads", "ff")])
def test_is_axes_leaf_matches(x):
    assert SH.is_axes_leaf(x) == JSH.is_axes_leaf(x)


# ----------------------------------------------------------- compression --

@pytest.mark.parametrize("n", [1, 2, 7, 99, 100, 101, 1000, 545_046_528])
@pytest.mark.parametrize("frac", [0.0, 0.001, 0.01, 0.25, 0.5, 1.0])
def test_topk_count_matches(n, frac):
    assert C.topk_count(n, frac) == JC.topk_count(n, frac)


def _tied(rng, shape):
    """Values in {0, -0, +-0.5, +-1, +-1.5}: many ties and zeros."""
    v = rng.integers(-3, 4, size=shape) / 2.0
    v = np.where(rng.random(shape) < 0.1, -0.0, v)
    return v.astype(np.float32)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10**9), st.sampled_from([0.0, 0.01, 0.1, 0.25, 0.5,
                                               0.9, 1.0]))
def test_topk_mask_matches_with_ties(seed, frac):
    rng = np.random.default_rng(seed)
    shape = tuple(int(d) for d in rng.integers(1, 12,
                                               size=rng.integers(1, 4)))
    x = _tied(rng, shape)
    want = _np(JC._topk_mask(jnp.asarray(x), frac))
    got = C._topk_mask(_t(x), frac)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == C.topk_count(x.size, frac)
    np.testing.assert_array_equal(C._topk(_t(x), frac).numpy(),
                                  _np(JC._topk(jnp.asarray(x), frac)))


def test_topk_mask_orders_ties_by_index():
    x = np.array([0.0, 3.0, -3.0, 1.0, 3.0, -0.0, 1.0], np.float32)
    for frac, keep in ((0.3, [1, 2]), (0.45, [1, 2, 4]),
                       (0.6, [1, 2, 3, 4]), (1.0, list(range(7)))):
        mask = C._topk_mask(_t(x), frac).numpy()
        assert list(np.flatnonzero(mask)) == keep
        np.testing.assert_array_equal(mask, _np(JC._topk_mask(x, frac)))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10**9), st.sampled_from([0.01, 0.1, 0.25, 0.5, 1.0]))
def test_topk_ef_compress_matches(seed, frac):
    rng = np.random.default_rng(seed)
    g = [_tied(rng, (13, 5)), rng.normal(size=(31,)).astype(np.float32)]
    e = [rng.normal(size=(13, 5)).astype(np.float32), _tied(rng, (31,))]
    ws, we = JC.topk_ef_compress([jnp.asarray(a) for a in g],
                                 [jnp.asarray(a) for a in e], frac)
    gs, ge = C.topk_ef_compress([_t(a) for a in g], [_t(a) for a in e], frac)
    for a, b in zip(gs + ge, ws + we):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for s, ne, a, b in zip(gs, ge, g, e):     # the EF invariant
        np.testing.assert_array_equal((s + ne).numpy(), a + b)


def _ref_uniforms(key, shapes):
    """The reference's int8 draws for a tree's leaves: fold_in(key, i)."""
    return [_t(jax.random.uniform(jax.random.fold_in(key, i), s))
            for i, s in enumerate(shapes)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_stochastic_matches_given_the_uniforms(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(40, 17)) * 10.0 ** rng.integers(-6, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    want = _np(JC._int8_stochastic(jnp.asarray(x), key))
    u = _t(jax.random.uniform(key, x.shape))
    np.testing.assert_array_equal(C._int8_stochastic(_t(x), u=u).numpy(),
                                  want)


@pytest.mark.parametrize("method", METHODS)
def test_dcn_send_matches(method):
    rng = np.random.default_rng(7)
    shapes = [(9, 4), (11,), (1,)]
    g = [_tied(rng, s) + rng.normal(size=s).astype(np.float32) * 0.01
         for s in shapes]
    e = ([rng.normal(size=s).astype(np.float32) for s in shapes]
         if method == "topk_ef" else {})
    key = JC.per_step_key(5, 3)
    ws, we = JC.dcn_send([jnp.asarray(a) for a in g],
                         [jnp.asarray(a) for a in e] if e else {},
                         method, 0.25, key)
    gs, ge = C.dcn_send([_t(a) for a in g], [_t(a) for a in e] if e else {},
                        method, 0.25, uniforms=_ref_uniforms(key, shapes))
    for a, b in zip(gs, ws):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert (ge == {}) == (we == {})
    for a, b in zip(ge or [], we or []):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_compress_tree_matches(method):
    rng = np.random.default_rng(11)
    shapes = [(6, 6), (3, 2, 5), (17,)]
    g = [rng.normal(size=s).astype(np.float32) for s in shapes]
    key = jax.random.PRNGKey(4)
    want = JC.compress_tree([jnp.asarray(a) for a in g], method, 0.1, key)
    got = C.compress_tree([_t(a) for a in g], method, 0.1,
                          uniforms=_ref_uniforms(key, shapes))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("frac", [0.01, 0.3])
def test_wire_bytes_match(method, frac):
    shapes = [(152, 36), (7,), (), (0,), (3, 3, 3)]
    for s in shapes:
        n = int(np.prod(s)) or 1
        assert C.leaf_wire_bytes(n, method, frac) == \
            JC.leaf_wire_bytes(n, method, frac)
    assert C.tree_wire_bytes([torch.zeros(s) for s in shapes], method,
                             frac) == \
        JC.tree_wire_bytes([jnp.zeros(s) for s in shapes], method, frac)


def test_unknown_methods_raise_value_errors():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown compression method"):
        C.compress_tree([x], "topk_ef")
    with pytest.raises(ValueError, match="unknown compression method"):
        C.leaf_wire_bytes(4, "zstd")
    with pytest.raises(ValueError, match="unknown compression method"):
        C.dcn_allreduce_tree([x[None]], {}, None, method="zstd")
    with pytest.raises(ValueError, match="unknown compression method"):
        C.cross_pod_allreduce(x, None, method="topk_ef")


def test_collectives_refuse_a_mesh_without_a_group():
    x = torch.ones(1, 4)
    with pytest.raises(ValueError, match="no process group"):
        C.dcn_allreduce_tree([x], {}, {"pod": 2}, method="none")
    with pytest.raises(ValueError, match="no 'pod' axis"):
        C.cross_pod_allreduce(x[0], {"data": 2}, method="none")
    with pytest.raises(ValueError, match=r"\(1, \.\.\.\) block"):
        C.dcn_allreduce_tree([torch.ones(2, 4)], {}, None, method="none")
    # an axis of size 1 is a no-op, as the reference's psum is
    red, err = C.dcn_allreduce_tree([x], {}, {"pod": 1}, method="none")
    assert torch.equal(red[0], x[0]) and err == {}


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A 1-rank gloo group and its ``pod`` DeviceMesh in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    store = tmp_path_factory.mktemp("one_rank") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    finally:
        dist.destroy_process_group()


def _collective_case(method):
    rng = np.random.default_rng(21)
    shapes = [(5, 8), (9,)]
    g = [rng.normal(size=s).astype(np.float32) for s in shapes]
    e = ([rng.normal(size=s).astype(np.float32) for s in shapes]
         if method == "topk_ef" else [])
    return shapes, g, e


@pytest.mark.parametrize("group", [False, True], ids=["no_mesh", "1_rank"])
@pytest.mark.parametrize("method", METHODS)
def test_dcn_allreduce_tree_matches_the_reference_on_one_pod(
        method, group, request):
    shapes, g, e = _collective_case(method)
    key = JC.per_step_key(2, 9)
    want, want_e = JC.dcn_allreduce_tree(
        [jnp.asarray(a)[None] for a in g],
        [jnp.asarray(a)[None] for a in e] or {}, jax.make_mesh((1,), ("pod",)),
        "pod", method, 0.2, key)
    mesh = request.getfixturevalue("one_rank_mesh") if group else None
    inputs = [_t(a)[None] for a in g]
    got, got_e = C.dcn_allreduce_tree(
        inputs, [_t(a)[None] for a in e] or {}, mesh, "pod", method, 0.2,
        uniforms=_ref_uniforms(jax.random.fold_in(key, 0), shapes))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    assert (got_e == {}) == (want_e == {})
    for a, b in zip(got_e or [], want_e or []):
        assert a.shape[0] == 1
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for a, b in zip(inputs, g):           # the caller's blocks are kept
        np.testing.assert_array_equal(a[0].numpy(), b)


@pytest.mark.parametrize("method", METHODS)
def test_dcn_allreduce_tree_hands_each_sum_to_out_before_the_next_leaf(
        method):
    """With ``out`` each leaf's sum and new residual reach ``out`` before
    the next leaf (and residual) is read, equal to the sums and residuals
    returned without it."""
    shapes, g, e = _collective_case(method)
    want, want_e = C.dcn_allreduce_tree(
        [_t(a)[None] for a in g], [_t(a)[None] for a in e] or {}, None,
        "pod", method, 0.2, 5)
    events = []

    def reads(arrays, what):
        for i, a in enumerate(arrays):
            events.append((what, i))
            yield _t(a)[None]

    def out(i, red, new_e):
        events.append(("out", i))
        return red, new_e

    got, got_e = C.dcn_allreduce_tree(
        reads(g, "leaf"), reads(e, "residual") if e else {}, None, "pod",
        method, 0.2, 5, out=out)
    assert got_e == {}
    steps = ("leaf", "residual", "out") if e else ("leaf", "out")
    assert events == [(what, i) for i in range(len(g)) for what in steps]
    for i, (red, new_e) in enumerate(got):
        assert torch.equal(red, want[i])
        assert (new_e is None) == (not e)
        if e:
            assert new_e.shape[0] == 1 and torch.equal(new_e, want_e[i])


@pytest.mark.parametrize("group", [False, True], ids=["no_mesh", "1_rank"])
@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_cross_pod_allreduce_matches_the_reference_on_one_pod(
        method, group, request):
    x = np.random.default_rng(5).normal(size=(4, 12)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = JC.cross_pod_allreduce(jnp.asarray(x), jax.make_mesh(
        (1,), ("pod",)), "pod", method, 0.25, key)
    mesh = request.getfixturevalue("one_rank_mesh") if group else None
    u = _t(jax.random.uniform(jax.random.fold_in(key, 0), x.shape))
    got = C.cross_pod_allreduce(_t(x), mesh, "pod", method, 0.25, u=u)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_mesh_shape_reads_a_device_mesh(one_rank_mesh):
    assert SH.mesh_shape(one_rank_mesh) == {"pod": 1}
    assert SH.pod_axis_size(one_rank_mesh) == 1
    assert SH.logical_to_spec(("batch", "dcn_pod"), (4, 1),
                              one_rank_mesh) == ("pod", None)


# the port's own draws: the reference's invariants

def test_int8_unbiased_and_bounded_over_keys():
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(256,)))
    scale = float(x.abs().max()) / 127.0
    acc = torch.zeros(256, dtype=torch.float64)
    keys = 64
    for k in range(keys):
        err = (C._int8_stochastic(x, C.per_step_key(k, 0)) - x).double()
        assert float(err.abs().max()) <= scale + 1e-6
        acc += err
    assert abs(float(acc.mean()) / keys) < 0.05 * scale


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10**9))
def test_int8_codes_in_range_within_one_step(seed):
    rng = np.random.default_rng(seed)
    x = _t(rng.normal(size=(33, 7)) * 10.0 ** rng.integers(-8, 4))
    q, s = C._int8_quantize(x, C.root_key(seed))
    assert torch.equal(q, q.round()) and float(q.abs().max()) <= 127
    assert bool(((q * s - x).abs() <= s).all())
    assert torch.equal(C._int8_stochastic(x, C.root_key(seed)), q * s)


def test_int8_key_threading():
    x = _t(np.random.default_rng(0).normal(size=(300,)))
    k5 = C.per_step_key(0, 5)
    a = C.compress_tree([x, x], "int8", key=k5)
    assert torch.equal(C.compress_tree([x, x], "int8", key=k5)[0], a[0])
    # the default is the fixed legacy key
    assert torch.equal(C.compress_tree([x], "int8")[0],
                       C.compress_tree([x], "int8", key=C.root_key(0))[0])
    # another step, pod, leaf or stream draws other noise
    others = [C.compress_tree([x], "int8", key=C.per_step_key(0, 6))[0],
              C.compress_tree([x], "int8", key=C.fold_in(k5, 1))[0],
              a[1],
              C.compress_tree([x], "int8",
                              key=C.fold_in(k5, C.LEGACY_STREAM))[0],
              C.compress_tree([x], "int8", key=C.per_step_key(1, 5))[0]]
    for o in others:
        assert not torch.equal(o, a[0])


def test_keys_are_fixed_integers():
    # a fixed mix: the same value in every process and on every run
    assert C.per_step_key(0, 0) == C.fold_in(C.root_key(0), 0)
    assert C.per_step_key(0, 0) == 2558736989570252433
    assert len({C.fold_in(C.root_key(s), t) for s in range(20)
                for t in range(20)}) == 400
    a = C.draw_uniforms((1000,), C.root_key(1), "cpu")
    assert torch.equal(a, C.draw_uniforms((1000,), C.root_key(1), "cpu"))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10**9), st.integers(1, 300),
       st.sampled_from([0.01, 0.1, 0.25, 0.5, 1.0]))
def test_ef_invariant_exact(seed, n, frac):
    rng = np.random.default_rng(seed)
    g, e = _t(rng.normal(size=n)), _t(rng.normal(size=n))
    (s,), (ne,) = C.topk_ef_compress([g], [e], frac)
    assert torch.equal(s + ne, g + e)
    assert int((s != 0).sum()) <= C.topk_count(n, frac)
    assert not bool(((s != 0) & (ne != 0)).any())


def test_ef_state_stays_finite_over_many_steps():
    g = [_t(np.random.default_rng(0).normal(size=(64,)))]
    err = C.init_error_state(g)
    assert err[0].dtype == torch.float32 and float(err[0].abs().max()) == 0
    for _ in range(50):
        _, err = C.topk_ef_compress(g, err, 0.1)
    assert bool(torch.isfinite(err[0]).all())


# ------------------------------------------------------------- straggler --

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("timeout", [1, 3])
def test_heartbeat_registry_matches(seed, timeout):
    rng = np.random.default_rng(seed)
    hosts = int(rng.integers(1, 6))
    ref, port = JaxHeartbeatRegistry(hosts, timeout), \
        HeartbeatRegistry(hosts, timeout)
    for _ in range(40):
        if rng.random() < 0.3:
            assert port.tick() == ref.tick()
        else:
            h = int(rng.integers(hosts))
            ref.beat(h)
            port.beat(h)


# ------------------------------------------------- gloo ranks (spawned) --

STEPS = 3
TRAIN_JOBS = [(m, {"dcn_compression": m, "dcn_topk_frac": R.TOPK_FRAC},
               STEPS) for m in METHODS]
DCN = {m: dcn for m, dcn, _ in TRAIN_JOBS}


def _spawn(world: int, out, train: list) -> list:
    """``world`` gloo ranks of ``R.worker``; joined within JOIN_TIMEOUT_S,
    else killed and failed. Returns each rank's results."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=R.worker,
                         args=(r, world, str(out / "store"), str(out),
                               train))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = sum(p.is_alive() for p in procs)
        assert alive == 0, (f"{alive} of {world} ranks still running after "
                            f"{JOIN_TIMEOUT_S} s")
        errs = [f.read_text() for f in sorted(out.glob("rank*.err"))]
        assert all(p.exitcode == 0 for p in procs) and not errs, (
            [p.exitcode for p in procs], errs)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(world)``: the spawned ranks' results (run once a world)."""
    runs = {}

    def get(world):
        if world not in runs:
            train = TRAIN_JOBS if world == 2 else TRAIN_JOBS + [
                ("topk_ef_1", DCN["topk_ef"], 1)]
            runs[world] = _spawn(world, tmp_path_factory.mktemp(
                f"ranks{world}"), train)
        return runs[world]
    return get


@pytest.fixture(scope="module")
def emulated():
    """``emulated(world, dcn, steps)``: the emulated route in this
    process."""
    runs = {}

    def get(world, dcn, steps):
        key = (world, tuple(sorted(dcn.items())), steps)
        if key not in runs:
            runs[key] = R.run_steps(dict(dcn, dcn_pods=world), steps)
        return runs[key]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_process_group_step_matches_the_emulated_route(ranks, emulated,
                                                       world, method):
    want = emulated(world, DCN[method], STEPS)
    assert want["route"] == "emulated" and want["pods"] == world
    for r, res in enumerate(ranks(world)):
        got = res["train"][method]
        assert got["route"] == "shard_map" and got["pods"] == world
        for gm, wm in zip(got["metrics"], want["metrics"]):
            assert gm.keys() == wm.keys()
            assert gm["dcn_bytes"] == wm["dcn_bytes"]
            assert gm["dcn_raw_bytes"] == wm["dcn_raw_bytes"]
            assert gm["lr"] == wm["lr"]
            if world == 2:
                assert gm == wm
            else:
                np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-6)
                np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"],
                                           rtol=1e-5)
        pairs = list(zip(got["params"] + got["mu"] + got["nu"],
                         want["params"] + want["mu"] + want["nu"]))
        if world == 2:
            assert all(torch.equal(a, b) for a, b in pairs)
        else:
            for a, b in pairs[:len(got["params"])]:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=2e-6)
        assert len(got["ef"]) == (len(got["params"])
                                  if method == "topk_ef" else 0)
        if world == 2:
            for a, b in zip(got["ef"], want["ef"]):
                assert a.shape[0] == 1 and torch.equal(a[0], b[r])


def test_process_group_residual_rows_at_4_ranks(ranks, emulated):
    """One step: each rank's residual row bit for bit against its row of
    the emulated (P, ...) residuals (no sum has reached them yet)."""
    want = emulated(4, DCN["topk_ef"], 1)
    for r, res in enumerate(ranks(4)):
        got = res["train"]["topk_ef_1"]
        assert len(got["ef"]) == len(want["ef"])
        for a, b in zip(got["ef"], want["ef"]):
            assert a.shape == (1, *b.shape[1:]) and torch.equal(a[0], b[r])


def _emulated_tree(world, method):
    """The emulated route's sum of the pods' sends, and their residuals."""
    acc, errs = None, []
    for p in range(world):
        g, e = R.collective_inputs(p, method)
        sent, ne = C.dcn_send(g, e or {}, method, R.TOPK_FRAC,
                              C.fold_in(R.COLLECTIVE_KEY, p))
        acc = [torch.zeros_like(s) for s in sent] if acc is None else acc
        for a, s in zip(acc, sent):
            a.add_(s)
        errs.append(ne)
    return acc, errs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("method", METHODS)
def test_dcn_allreduce_tree_on_ranks_matches_the_emulated_fold(
        ranks, world, method):
    want, want_e = _emulated_tree(world, method)
    for r, res in enumerate(ranks(world)):
        red, new_e = res["tree"][method]
        for a, b in zip(red, want):
            if world == 2:
                assert torch.equal(a, b)
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-6)
        if method == "topk_ef":
            for a, b in zip(new_e, want_e[r]):
                assert torch.equal(a[0], b)
        else:
            assert new_e == {}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("method", ["none", "int8", "topk"])
def test_cross_pod_allreduce_on_ranks_matches_the_emulated_sum(
        ranks, world, method):
    want = None
    for p in range(world):
        x = R.collective_inputs(p, method)[0][0]
        if method == "int8":
            x = C._int8_stochastic(x, C.fold_in(R.COLLECTIVE_KEY, p))
        elif method == "topk":
            x = C._topk(x, R.TOPK_FRAC)
        want = x.clone() if want is None else want + x
    for res in ranks(world):
        got = res["array"][method]
        if world == 2:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6)
