"""Streaming clustering of the PyTorch port against the JAX package, on the
CPU: the ``StreamingClusterer`` over several batch partitions of one
stream (consolidation, stale snapshots, in-batch spawns, the resolve
chain), the clustering endpoint of ``DBSearchServer`` (clustering alone,
mixed with search, independent tenants, validation) and the
``serve_cluster`` launcher.

Both packages get the same numpy HVs, made from a seed. The reference's
bit-packed distance step runs ``hamming_pop_pallas`` in Pallas interpret
mode, as the JAX package's own tests run it on the CPU. No test calls a
launcher of the JAX package. Tolerance: exact (cluster ids, spawn flags,
distances, merges, remaps, centroids, summaries, search results).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import BankRegistry as JRegistry
from repro.serve import ClusteringConfig as JConfig
from repro.serve import DBSearchServer as JServer
from repro.serve import StreamingClusterer as JClusterer
from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.launch import serve_cluster
from repro_torch.serve import (
    BankRegistry,
    ClusterAssignment,
    ClusteringConfig,
    DBSearchServer,
    SearchExecutor,
    StreamingClusterer,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

CPU = "cpu"
D = 64


def _proto_stream(seed, n_proto, per_proto, flip_bits, d=D):
    """Prototypes with ``flip_bits`` random sign flips per point, in
    shuffled order: intra-cluster distances <= 2 * flip_bits, inter
    ~ d / 2."""
    rng = np.random.default_rng(seed)
    protos = rng.choice([-1, 1], size=(n_proto, d)).astype(np.int8)
    hvs = np.repeat(protos, per_proto, axis=0)
    for hv in hvs:
        flips = rng.choice(d, size=flip_bits, replace=False)
        hv[flips] = -hv[flips]
    return hvs[rng.permutation(len(hvs))]


def _stream_through(cl, hvs, batch_size, to_host):
    """The executor's dispatch / finalize pair, batch by batch."""
    out = []
    for i in range(0, hvs.shape[0], batch_size):
        batch = hvs[i:i + batch_size]
        c0, sv = cl.num_clusters, cl.struct_version
        d = cl.snapshot_distances(batch)
        out.extend(cl.assign_batch(batch, None if d is None else to_host(d),
                                   c0, sv))
    return out


def _as_tuples(assigns):
    return [(a.cluster_id, a.spawned, a.distance) for a in assigns]


def _assert_same_state(tcl, jcl, assigns):
    assert tcl.summary() == jcl.summary()
    assert tcl.struct_version == jcl.struct_version
    np.testing.assert_array_equal(tcl.labels_for(assigns),
                                  jcl.labels_for(assigns))
    for cid in range(tcl._next_id):
        assert tcl.resolve(cid) == jcl.resolve(cid)
        np.testing.assert_array_equal(tcl.centroid(cid), jcl.centroid(cid))
    np.testing.assert_array_equal(tcl._acc, jcl._acc)
    np.testing.assert_array_equal(tcl._counts_buf[:tcl.num_clusters],
                                  jcl._counts)
    # the resident device bank is the sign snapshot of the live rows
    bank = tcl.device_bank()
    want = (bitpack_bipolar(torch.from_numpy(jcl._cent))
            if tcl.cfg.packed else torch.from_numpy(jcl._cent))
    assert torch.equal(bank, want)


# consolidation with merges: streaming (threshold 6) splits prototypes
# that complete linkage (link threshold 14) folds back together
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("batch_size", [1, 5, 16, 120])
def test_streaming_clusterer_replays_reference(batch_size, pack):
    hvs = _proto_stream(11, n_proto=6, per_proto=8, flip_bits=4)
    kw = dict(dim=D, threshold=6.0, link_threshold=14.0,
              consolidate_every=16, pack=pack)
    jcl = JClusterer(JConfig(**kw))
    tcl = StreamingClusterer(ClusteringConfig(**kw), CPU)
    want = _stream_through(jcl, hvs, batch_size, np.asarray)
    got = _stream_through(tcl, hvs, batch_size, lambda d: d.numpy())
    assert _as_tuples(got) == _as_tuples(want)
    assert all(isinstance(a, ClusterAssignment) for a in got)
    assert tcl.merges > 0 and tcl.consolidations > 0
    _assert_same_state(tcl, jcl, got)


def _stale_scenario(cl_cls, cfg_cls, to_host):
    """Two founders that consolidation merges, then a batch whose
    snapshot predates the merge (the reference test's scenario)."""
    rng = np.random.default_rng(5)
    a = rng.choice([-1, 1], size=D).astype(np.int8)
    b = a.copy()
    b[:10] = -b[:10]
    cl = cl_cls(cfg_cls(dim=D, threshold=4.0, link_threshold=12.0,
                        consolidate_every=2))
    out = _stream_through(cl, np.stack([a, b]), 2, to_host)
    merged = np.where(a.astype(np.int32) + b >= 0, 1, -1).astype(np.int8)
    probe = merged.copy()
    probe[:1] = -probe[:1]
    out += cl.assign_batch(probe[None, :], np.asarray([[50.0, 0.0]]), 2,
                           struct_version=0)
    return cl, out


def _in_batch_spawn_scenario(cl_cls, cfg_cls, to_host):
    """A spectrum that spawns mid-batch catches the rest of its batch
    (host-scored rows past the snapshot), ties to the lower row."""
    rng = np.random.default_rng(3)
    p, q = (rng.choice([-1, 1], size=D).astype(np.int8) for _ in range(2))
    near_p = p.copy()
    near_p[:2] = -near_p[:2]
    cl = cl_cls(cfg_cls(dim=D, threshold=5.0))
    out = _stream_through(cl, np.stack([q]), 1, to_host)
    out += _stream_through(cl, np.stack([p, near_p, p, q, near_p]), 5,
                           to_host)
    return cl, out


@pytest.mark.parametrize("scenario", [_stale_scenario,
                                      _in_batch_spawn_scenario])
def test_clusterer_scenarios_match_reference(scenario):
    jcl, want = scenario(JClusterer, JConfig, np.asarray)
    tcl, got = scenario(lambda cfg: StreamingClusterer(cfg, CPU),
                        ClusteringConfig, lambda d: d.numpy())
    assert _as_tuples(got) == _as_tuples(want)
    _assert_same_state(tcl, jcl, got)


def test_plain_hamming_seam_gives_the_same_assignments():
    """The plain distance function (the chip check's replay) and the
    wrapper agree; on the CPU both run the plain version."""
    from repro_torch.kernels.hamming_pop import hamming_pop_plain
    hvs = _proto_stream(2, n_proto=4, per_proto=6, flip_bits=3)
    cfg = ClusteringConfig(dim=D, threshold=8.0, consolidate_every=8)
    a = StreamingClusterer(cfg, CPU)
    b = StreamingClusterer(cfg, CPU, hamming=hamming_pop_plain)
    assert (_as_tuples(_stream_through(a, hvs, 4, lambda d: d.numpy()))
            == _as_tuples(_stream_through(b, hvs, 4, lambda d: d.numpy())))


def _drive(srv, ops, clock):
    """Submits ``ops`` ((kind, tenant, hv) in order), stepping the server
    after every third submission with the clock advanced; returns rid ->
    result."""
    done = []
    for i, (kind, tenant, hv) in enumerate(ops):
        if kind == "cluster":
            srv.submit_cluster(hv, tenant=tenant)
        else:
            srv.submit(hv, tenant=tenant)
        if i % 3 == 2:
            clock[0] += 0.02
            done.extend(srv.step())
    done.extend(srv.run_until_drained())
    return {r.rid: r.result for r in done}


@pytest.mark.parametrize("mode", ["alone", "mixed", "tenants"])
def test_server_clustering_matches_reference(mode):
    hvs = _proto_stream(6, n_proto=5, per_proto=6, flip_bits=3)
    ccfg = dict(dim=D, threshold=10.0, link_threshold=14.0,
                consolidate_every=12)
    rng = np.random.default_rng(6)
    queries = rng.choice([-1, 1], size=(8, D)).astype(np.int8)
    ops = [("cluster", "t1" if mode == "tenants" and i % 2 else "a", hv)
           for i, hv in enumerate(hvs)]
    jreg, treg = JRegistry(), BankRegistry()
    if mode == "mixed":
        refs = rng.choice([-1, 1], size=(20, D)).astype(np.int8)
        dec = rng.choice([-1, 1], size=(10, D)).astype(np.int8)
        jreg.register("a", jnp.asarray(refs), decoys=jnp.asarray(dec))
        treg.register("a", torch.from_numpy(refs),
                      decoys=torch.from_numpy(dec))
        for i, q in enumerate(queries):
            ops.insert(3 * i + 1, ("search", "a", q))
    kw = dict(k=3, fdr=0.5, max_batch_size=4, flush_timeout_s=0.01,
              buckets=3)
    jclock, tclock = [0.0], [0.0]
    jsrv = JServer(jreg, clock=lambda: jclock[0],
                   clustering=JConfig(**ccfg), **kw)
    tsrv = DBSearchServer(treg, clock=lambda: tclock[0],
                          clustering=ClusteringConfig(**ccfg),
                          cluster_device=CPU, **kw)
    want = _drive(jsrv, ops, jclock)
    got = _drive(tsrv, ops, tclock)
    assert sorted(got) == sorted(want) == list(range(len(ops)))
    for rid, w in want.items():
        g = got[rid]
        if ops[rid][0] == "cluster":
            assert dataclasses.astuple(g) == dataclasses.astuple(w)
        else:
            np.testing.assert_array_equal(g.indices, np.asarray(w.indices))
            assert (g.accept, g.match) == (w.accept, w.match)
    js, ts = jsrv.summary(), tsrv.summary()
    assert ts["clustering"] == js["clustering"]
    for key in ("count", "batches", "buckets"):
        assert ts[key] == js[key], key
    tenants = {"a", "t1"} if mode == "tenants" else {"a"}
    assert set(tsrv.clusterers) == tenants
    assert sum(c.assigned for c in tsrv.clusterers.values()) == len(hvs)


@pytest.mark.parametrize("build,args,match", [
    (dict(), (np.zeros(D, np.int8),), "without clustering"),
    (dict(clustering=ClusteringConfig(dim=D, threshold=4.0)),
     (np.zeros(D + 1, np.int8),), "query shape"),
])
def test_submit_cluster_validation(build, args, match):
    srv = DBSearchServer(BankRegistry(), cluster_device=CPU, **build)
    with pytest.raises(ValueError, match=match):
        srv.submit_cluster(*args)


@pytest.mark.parametrize("flags", [["--tenants", "2",
                                    "--consolidate-every", "16"],
                                   ["--no-pack", "--max-batch", "8"]])
def test_serve_cluster_launcher_on_cpu(flags, capsys):
    seen = []

    class Recording(SearchExecutor):
        def dispatch(self, reqs):
            h = super().dispatch(reqs)
            seen.append((h.n, h.hvs.shape))
            return h

    s = serve_cluster.main(["--reduced", "--device", "cpu", "--hd-dim", "64",
                            "--identities", "6", "--spectra-per-identity",
                            "4", *flags], executor_cls=Recording)
    out = capsys.readouterr().out
    tenants = 2 if "--tenants" in flags else 1
    assert s["count"] == s["total"] == 24 * tenants
    assert len(seen) == s["batches"] and sum(n for n, _ in seen) == s["count"]
    assert all(rows in s["buckets"] and cols == 64 for _, (rows, cols) in seen)
    for tenant in [f"tenant{t}" for t in range(tenants)]:
        q = s["cluster_quality"][tenant]
        assert q["clusters"] >= 1 and q["assigned"] == 24
        assert 0.0 <= q["incorrect_ratio"] <= 1.0
        assert 0.0 <= q["clustered_ratio"] <= 1.0
    assert "spectra/sec" in out and "kernel launches: hamming_pop" in out
    # no CUDA device: no device time, and the kernel never launched
    assert "device distances not timed" in out
    assert s["device_busy_s"] is None and s["launches"]["hamming_pop"] == 0
    assert 0 <= s["sleep_s"] <= s["span_s"]
