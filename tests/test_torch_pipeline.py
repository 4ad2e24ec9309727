"""The end-to-end pipelines of ``repro_torch.core.pipeline`` (clustering
and DB search, ideal and analog) against ``repro.core.pipeline``, on the
CPU.

Parity runs take the reference's random draws: its codebooks
(``make_codebooks`` is a threefry draw) cross through
``convert.codebooks_from_numpy``, and its write noise, reproduced here
with the reference's own keys (DB search: ``PRNGKey(seed + 29)`` split
into the targets' and the decoys' keys; clustering: ``PRNGKey(seed +
17)`` split once per bucket of two or more spectra), is returned by a
stand-in for the port pipeline's ``apply_write_noise`` in call order.

* equal: labels, ratios and cluster counts; matches, accept masks,
  ``num_identified``, ``num_no_candidate`` and recall; the cost reports;
* rtol 1e-5 / atol 1e-3: the analog scores of ``imc_scores`` (the
  kernel's fused partials against XLA's sum order);
* the port's own draws (``torch.Generator``s) meet the reference tests'
  bounds on the same data (``tests/test_pipeline.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hd.encoding as ref_encoding
import repro.core.imc.device as ref_device
import repro.core.pipeline as ref_pipeline
from repro.dist import sharding
from repro.spectra import SyntheticMSConfig, generate_dataset
from repro.spectra.preprocess import bucket_by_precursor
from repro.spectra.synthetic import generate_query_set
from repro_torch.convert import codebooks_from_numpy, imc_weights_from_numpy
from repro_torch.core import pipeline
from repro_torch.core.pipeline import (
    SpecPCMConfig,
    imc_scores,
    mean_of_count,
    query_chunk,
    run_clustering,
    run_db_search,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _no_global_mesh():
    sharding.set_mesh(None)


@pytest.fixture(scope="module")
def ds():
    return generate_dataset(SyntheticMSConfig(
        num_identities=24, spectra_per_identity=8, num_bins=1024))


@pytest.fixture(scope="module")
def refs(ds):
    t = ds.templates
    return t / jnp.maximum(t.max(1, keepdims=True), 1e-6)


@pytest.fixture(scope="module")
def ref_prec(ds):
    return jnp.asarray(np.asarray(ds.precursor)[::8])


@pytest.fixture(scope="module")
def queries(ds):
    return generate_query_set(ds, SyntheticMSConfig(
        num_identities=24, spectra_per_identity=8, num_bins=1024), 48)


def _ref_cfg(cfg):
    return ref_pipeline.SpecPCMConfig(**dataclasses.asdict(cfg))


@pytest.fixture
def ref_codebooks(monkeypatch):
    """The port pipeline encodes with the reference's codebooks."""
    def make(enc_cfg, device="cuda"):
        id_hvs, level_hvs = ref_encoding.make_codebooks(
            ref_encoding.HDEncoderConfig(**dataclasses.asdict(enc_cfg)))
        return codebooks_from_numpy(np.asarray(id_hvs),
                                    np.asarray(level_hvs), device)

    monkeypatch.setattr(pipeline, "make_codebooks", make)


class _Noise:
    """Stands in for the port pipeline's ``apply_write_noise``: returns the
    reference's noisy arrays in call order, each checked against the
    weights it replaces."""

    def __init__(self, arrays):
        self.arrays = list(arrays)
        self.calls = 0

    def __call__(self, generator, weights, cfg):
        a = self.arrays[self.calls]
        self.calls += 1
        assert a.shape == tuple(weights.shape)
        assert isinstance(generator, torch.Generator)
        return imc_weights_from_numpy(a, weights.device)


def _db_noise(cfg, refs):
    """The reference run_db_search's noisy targets and decoys."""
    rcfg = _ref_cfg(cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(cfg.seed + 29))
    r = ref_pipeline.encode_and_pack(refs, rcfg)
    d = ref_pipeline.encode_and_pack(refs[:, ::-1], rcfg)
    return [np.asarray(ref_device.apply_write_noise(k, p, rcfg.device_cfg()))
            for k, p in ((k1, r), (k2, d))]


def _cluster_noise(cfg, ds, bucket_width):
    """The reference run_clustering's noisy bucket banks, in bucket order."""
    rcfg = _ref_cfg(cfg)
    packed = ref_pipeline.encode_and_pack(ds.spectra, rcfg)
    key = jax.random.PRNGKey(cfg.seed + 17)
    out = []
    for bidx in bucket_by_precursor(np.asarray(ds.precursor), bucket_width):
        if len(bidx) < 2:
            continue
        key, sub = jax.random.split(key)
        out.append(np.asarray(ref_device.apply_write_noise(
            sub, packed[jnp.asarray(bidx)], rcfg.device_cfg())))
    return out


def _same_search(got, want):
    np.testing.assert_array_equal(got.matches, want.matches)
    np.testing.assert_array_equal(got.accepted, want.accepted)
    assert got.matches.dtype == want.matches.dtype
    assert got.num_identified == want.num_identified
    assert got.num_no_candidate == want.num_no_candidate
    assert got.recall == want.recall
    assert dataclasses.asdict(got.cost) == dataclasses.asdict(want.cost)


def _same_clusters(got, want):
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.clustered_ratio == want.clustered_ratio
    assert got.incorrect_ratio == want.incorrect_ratio
    assert got.num_clusters == want.num_clusters
    assert dataclasses.asdict(got.cost) == dataclasses.asdict(want.cost)


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------------
# DB search against the reference
# --------------------------------------------------------------------------

DB_CASES = {
    "mlc3": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16), True),
    "mlc3-ideal": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16,
                                 ideal=True), True),
    "tiny-dim": (SpecPCMConfig(hd_dim=96, mlc_bits=3, num_levels=16), True),
    "dim-2049": (SpecPCMConfig(hd_dim=2049, mlc_bits=3, num_levels=16),
                 True),
    "slc": (SpecPCMConfig(hd_dim=1024, mlc_bits=1, num_levels=16), True),
    "tite2-wv3-adc4": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16,
                                     material="tite2", write_verify=3,
                                     adc_bits=4, seed=5), True),
    "closed-window": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16),
                      False),
    "closed-window-ideal": (SpecPCMConfig(hd_dim=1026, mlc_bits=3,
                                          num_levels=16, ideal=True), False),
}


@pytest.mark.parametrize("case", sorted(DB_CASES))
@pytest.mark.parametrize("phantoms", [False, True])
def test_db_search_equals_the_reference(case, phantoms, ds, refs, ref_prec,
                                        queries, ref_codebooks, monkeypatch):
    """With the reference's codebooks and noise the port's report equals
    the reference's; ``phantoms`` puts five queries' precursors far
    outside every window (empty windows, ``valid=False`` in the FDR)."""
    cfg, open_search = DB_CASES[case]
    prec = _np(queries.precursor).copy()
    if phantoms:
        prec[:5] = 1e6
    noise = _Noise([] if cfg.ideal else _db_noise(cfg, refs))
    monkeypatch.setattr(pipeline, "apply_write_noise", noise)
    want = ref_pipeline.run_db_search(
        queries.spectra, jnp.asarray(prec), refs, ref_prec, _ref_cfg(cfg),
        query_identity=queries.identity, ref_identity=jnp.arange(24),
        open_search=open_search)
    got = run_db_search(_np(queries.spectra), prec, _np(refs), _np(ref_prec),
                        cfg, query_identity=_np(queries.identity),
                        ref_identity=np.arange(24), open_search=open_search,
                        device=CPU)
    assert noise.calls == len(noise.arrays)
    _same_search(got, want)
    if phantoms:
        assert got.num_no_candidate == 5


def test_db_search_does_not_depend_on_the_chunking(ds, refs, ref_prec,
                                                   queries, monkeypatch):
    """Queries scored 5 at a time (10 chunks) give the one-chunk report."""
    cfg = SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16)
    args = (_np(queries.spectra), _np(queries.precursor), _np(refs),
            _np(ref_prec), cfg)
    kw = dict(query_identity=_np(queries.identity),
              ref_identity=np.arange(24), device=CPU)
    assert query_chunk(24) >= 48 and query_chunk(24) % 32 == 0
    whole = run_db_search(*args, **kw)
    monkeypatch.setattr(pipeline, "SCORE_CHUNK_ELEMS", 24 * 5)
    assert query_chunk(24) == 5
    chunked = run_db_search(*args, **kw)
    _same_search(chunked, whole)


@pytest.mark.parametrize("cfg", [
    SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16),
    SpecPCMConfig(hd_dim=2049, mlc_bits=3, num_levels=16, adc_bits=5,
                  material="tite2", write_verify=2),
    SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16, ideal=True)])
def test_imc_scores_equal_the_reference(cfg, refs, queries, ref_codebooks,
                                        monkeypatch):
    rcfg = _ref_cfg(cfg)
    q = ref_pipeline.encode_and_pack(queries.spectra, rcfg)
    r = ref_pipeline.encode_and_pack(refs, rcfg)
    key = jax.random.PRNGKey(3)
    want = np.asarray(ref_pipeline.imc_scores(q, r, rcfg, key))
    noise = _Noise([] if cfg.ideal else [np.asarray(
        ref_device.apply_write_noise(key, r, rcfg.device_cfg()))])
    monkeypatch.setattr(pipeline, "apply_write_noise", noise)
    got = imc_scores(torch.from_numpy(np.array(q)),
                     torch.from_numpy(np.array(r)), cfg, torch.Generator())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if cfg.ideal:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Q,R,p", [(48, 24, 0.7), (7, 13, 0.0), (3, 1, 1.0),
                                   (200, 333, 0.02), (1, 5000, 0.5)])
def test_candidate_fraction_is_jnp_mean(Q, R, p):
    mask = np.random.default_rng(Q * R).random((Q, R)) < p
    want = float(jnp.mean(jnp.asarray(mask).astype(jnp.float32)))
    assert mean_of_count(int(mask.sum()), Q * R) == want


# --------------------------------------------------------------------------
# clustering against the reference
# --------------------------------------------------------------------------

CLUSTER_CASES = {
    "mlc3": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16), 0.80,
             60.0),
    "mlc3-ideal": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16,
                                 ideal=True), 0.80, 60.0),
    "slc": (SpecPCMConfig(hd_dim=1024, mlc_bits=1, num_levels=16), 0.80,
            60.0),
    "tite2-wide-buckets": (SpecPCMConfig(hd_dim=2049, mlc_bits=3,
                                         num_levels=16, material="tite2",
                                         write_verify=3, seed=2), 0.70,
                           400.0),
    "one-bucket": (SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16,
                                 adc_bits=5), 0.75, 5000.0),
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_clustering_equals_the_reference(case, ds, ref_codebooks,
                                         monkeypatch):
    cfg, frac, width = CLUSTER_CASES[case]
    noise = _Noise([] if cfg.ideal else _cluster_noise(cfg, ds, width))
    monkeypatch.setattr(pipeline, "apply_write_noise", noise)
    want = ref_pipeline.run_clustering(ds.spectra, ds.precursor, ds.identity,
                                       _ref_cfg(cfg), threshold_frac=frac,
                                       bucket_width=width)
    got = run_clustering(_np(ds.spectra), _np(ds.precursor),
                         _np(ds.identity), cfg, threshold_frac=frac,
                         bucket_width=width, device=CPU)
    assert noise.calls == len(noise.arrays)
    _same_clusters(got, want)


# --------------------------------------------------------------------------
# the port's own draws (tests/test_pipeline.py's bounds)
# --------------------------------------------------------------------------

class TestClusteringPipeline:
    def test_clusters_replicates(self, ds):
        cfg = SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16)
        rep = run_clustering(_np(ds.spectra), _np(ds.precursor),
                             _np(ds.identity), cfg, device=CPU)
        assert rep.clustered_ratio > 0.8
        assert rep.incorrect_ratio < 0.05
        assert rep.cost.latency_s > 0 and rep.cost.energy_j > 0

    def test_slc_quality_geq_mlc3(self, ds):
        args = (_np(ds.spectra), _np(ds.precursor), _np(ds.identity))
        slc = run_clustering(*args, SpecPCMConfig(hd_dim=1024, mlc_bits=1,
                                                  num_levels=16), device=CPU)
        mlc = run_clustering(*args, SpecPCMConfig(hd_dim=1026, mlc_bits=3,
                                                  num_levels=16), device=CPU)
        assert slc.clustered_ratio >= mlc.clustered_ratio - 0.05
        assert slc.incorrect_ratio < 0.05 and mlc.incorrect_ratio < 0.05

    def test_ideal_vs_noisy(self, ds):
        ideal = run_clustering(_np(ds.spectra), _np(ds.precursor),
                               _np(ds.identity),
                               SpecPCMConfig(hd_dim=1026, mlc_bits=3,
                                             num_levels=16, ideal=True),
                               device=CPU)
        assert ideal.clustered_ratio > 0.8

    def test_seed_fixes_the_result(self, ds):
        args = (_np(ds.spectra), _np(ds.precursor), _np(ds.identity),
                SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16))
        a = run_clustering(*args, device=CPU)
        b = run_clustering(*args, device=CPU)
        np.testing.assert_array_equal(a.labels, b.labels)


class TestDBSearchPipeline:
    def _run(self, queries, refs, ref_prec, cfg, prec=None):
        return run_db_search(
            queries.spectra, queries.precursor if prec is None else prec,
            _np(refs), _np(ref_prec), cfg,
            query_identity=queries.identity, ref_identity=np.arange(24),
            device=CPU)

    @pytest.fixture
    def port_queries(self, queries):
        """The reference's query set as tensors (the entry moves them)."""
        return dataclasses.replace(
            queries, spectra=torch.from_numpy(_np(queries.spectra)),
            precursor=torch.from_numpy(_np(queries.precursor)),
            identity=torch.from_numpy(_np(queries.identity)))

    def test_identifies_peptides_at_fdr(self, port_queries, refs, ref_prec):
        cfg = SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16)
        rep = self._run(port_queries, refs, ref_prec, cfg)
        assert rep.num_identified > 0.5 * port_queries.spectra.shape[0]
        assert rep.recall > 0.5
        assert rep.cost.latency_s > 0

    def test_dimension_hurts_when_tiny(self, port_queries, refs, ref_prec):
        small, large = (self._run(port_queries, refs, ref_prec, SpecPCMConfig(
            hd_dim=d, mlc_bits=3, num_levels=16)) for d in (96, 2049))
        assert large.recall >= small.recall

    def test_no_candidate_queries_do_not_poison_fdr(self, port_queries, refs,
                                                    ref_prec):
        cfg = SpecPCMConfig(hd_dim=1026, mlc_bits=3, num_levels=16)
        prec = port_queries.precursor.clone()
        prec[:5] = 1e6  # far outside every reference window
        rep = self._run(port_queries, refs, ref_prec, cfg, prec)
        base = self._run(port_queries, refs, ref_prec, cfg)
        assert rep.num_no_candidate == 5
        assert (rep.matches[:5] == -1).all() and not rep.accepted[:5].any()
        assert rep.num_identified >= base.num_identified - 5
        assert rep.num_identified > 0.5 * (48 - 5)

    def test_analog_keeps_the_ideal_quality(self, port_queries, refs,
                                            ref_prec):
        """Fig. 10: MLC3 with write-verify identifies at least 90% as many
        queries as the ideal route on the same data."""
        kw = dict(hd_dim=2049, mlc_bits=3, num_levels=16, material="tite2",
                  write_verify=3)
        analog = self._run(port_queries, refs, ref_prec, SpecPCMConfig(**kw))
        ideal = self._run(port_queries, refs, ref_prec,
                          SpecPCMConfig(ideal=True, **kw))
        assert analog.num_identified >= 0.9 * ideal.num_identified
