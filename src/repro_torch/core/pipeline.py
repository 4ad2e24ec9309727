"""End-to-end SpecPCM pipelines in PyTorch: spectral clustering and DB
search (Figs. 1 and 2).

Counterpart of ``repro.core.pipeline``. The paper's two applications,
wired through the full stack:

  spectra -> HD encode (Eq. 1) -> dimension packing (§III.B)
          -> program PCM arrays (write noise, §III.E)
          -> IMC MVM with DAC/ADC quantization (§III.C; the ``imc_mvm``
             kernel on the card)
          -> [clustering] complete-linkage merge loop
          -> [DB search] argmax + target-decoy FDR

Every hardware knob (bits/cell, write-verify, ADC bits, HD dim, material)
is a field of :class:`SpecPCMConfig`; ``ideal=True`` bypasses the analog
chain (exact integer scores).

Random draws: codebooks and write noise come from ``torch.Generator``s,
one per entry, drawn in the reference's order (DB search: seed + 29, the
targets' noise, then the decoys'; clustering: seed + 17, one draw per
bucket of two or more spectra). They differ from the reference's threefry
draws; parity runs hand the reference's codebooks and noisy arrays in.

DB search scores the queries in chunks, so no (Q, R) score matrix
outgrows :data:`SCORE_CHUNK_ELEMS` elements; rows are independent, so
the results do not depend on the chunking.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hd.clustering import (
    clustered_spectra_ratio,
    complete_linkage,
    incorrect_clustering_ratio,
)
from repro_torch.core.hd.encoding import (
    HDEncoderConfig,
    encode_batch,
    make_codebooks,
)
from repro_torch.core.hd.packing import pack_dimensions
from repro_torch.core.hd.similarity import dot_similarity
from repro_torch.core.imc import energy as energy_mod
from repro_torch.core.imc.array import ArrayConfig, imc_mvm_reference
from repro_torch.core.imc.device import DeviceConfig, apply_write_noise
from repro_torch.device import resolve_device
from repro_torch.spectra.fdr import fdr_filter, make_decoys
from repro_torch.spectra.preprocess import (
    bucket_by_precursor,
    candidate_window_mask,
)

# elements of one chunk's (queries, refs) score matrix in DB search: 2 GiB
# of float32 (896 queries a chunk against iPRG2012's 581,196 targets)
SCORE_CHUNK_ELEMS = 1 << 29
# the masked scores (repro.core.pipeline: float32 -1e9, exact in float32)
MASKED_SCORE = -1e9


@dataclasses.dataclass(frozen=True)
class SpecPCMConfig:
    """Software-visible configuration (the ISA parameter block)."""
    hd_dim: int = 2048
    num_levels: int = 32
    mlc_bits: int = 3
    adc_bits: int = 6
    dac_bits: int = 3
    write_verify: int = 0
    material: str = "sb2te3"
    ideal: bool = False        # bypass analog non-idealities
    seed: int = 0

    def array_cfg(self) -> ArrayConfig:
        return ArrayConfig(dac_bits=self.dac_bits, adc_bits=self.adc_bits,
                           bits_per_cell=self.mlc_bits)

    def device_cfg(self) -> DeviceConfig:
        return DeviceConfig(material=self.material,
                            bits_per_cell=self.mlc_bits,
                            write_verify_cycles=self.write_verify)


def encode_and_pack(spectra: torch.Tensor, cfg: SpecPCMConfig) -> torch.Tensor:
    """spectra (N, F) in [0, 1] -> packed HVs (N, D/n) int8, on the
    spectra's device, with the codebooks of ``cfg.seed``."""
    enc_cfg = HDEncoderConfig(dim=cfg.hd_dim, num_features=spectra.shape[1],
                              num_levels=cfg.num_levels, seed=cfg.seed)
    id_hvs, level_hvs = make_codebooks(enc_cfg, device=spectra.device)
    hvs = encode_batch(spectra, id_hvs, level_hvs)
    return pack_dimensions(hvs, cfg.mlc_bits)


def _program(packed: torch.Tensor, cfg: SpecPCMConfig,
             generator: torch.Generator) -> torch.Tensor:
    """The bank as the score step reads it: the packed HVs themselves when
    ``cfg.ideal``, else their noisy programmed weights."""
    if cfg.ideal:
        return packed
    return apply_write_noise(generator, packed, cfg.device_cfg())


def _scores(queries_packed: torch.Tensor, bank: torch.Tensor,
            cfg: SpecPCMConfig) -> torch.Tensor:
    if cfg.ideal:
        return dot_similarity(queries_packed, bank).to(torch.float32)
    return imc_mvm_reference(queries_packed, bank, cfg.array_cfg())


def imc_scores(queries_packed: torch.Tensor, refs_packed: torch.Tensor,
               cfg: SpecPCMConfig, generator: torch.Generator
               ) -> torch.Tensor:
    """(Q, Dp) x (R, Dp) -> (Q, R) float32 scores through the modeled
    analog chain (exact dot products when ``cfg.ideal``); the write noise
    is drawn from ``generator``, a generator on the operands' device."""
    return _scores(queries_packed, _program(refs_packed, cfg, generator),
                   cfg)


def _on(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))  # a copy: the input may be read-only
    return x.to(device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def mean_of_count(count: int, n: int) -> float:
    """``jnp.mean`` of a float32 mask with ``count`` ones among ``n``: XLA
    multiplies the float32 sum by the float32 reciprocal of n. The count is
    exact here; past 2**24 ones the reference's float32 sum is not, and
    nothing compares against it there."""
    return float(np.float32(count) * (np.float32(1) / np.float32(n)))


# --------------------------------------------------------------------------
# clustering (Fig. 1)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterReport:
    labels: np.ndarray
    clustered_ratio: float
    incorrect_ratio: float
    num_clusters: int
    cost: "energy_mod.CostReport"


def run_clustering(
    spectra,
    precursor,
    identity,
    cfg: SpecPCMConfig,
    threshold_frac: float = 0.80,
    bucket_width: float = 60.0,
    device: str | torch.device = "cuda",
) -> ClusterReport:
    """Full clustering pipeline on ``device`` (numpy or tensor inputs are
    moved there). ``threshold_frac`` is the merge threshold as a fraction
    of hd_dim/2 (the expected Hamming distance of unrelated HVs)."""
    dev = resolve_device(device)
    generator = _generator(cfg.seed + 17, dev)
    packed = encode_and_pack(_on(spectra, dev).to(torch.float32), cfg)
    n = packed.shape[0]
    labels = np.arange(n, dtype=np.int64)
    threshold = threshold_frac * cfg.hd_dim / 2

    for bidx in bucket_by_precursor(_host(precursor), bucket_width):
        if len(bidx) < 2:
            continue
        hv_b = packed[torch.from_numpy(bidx).to(dev)]
        scores = imc_scores(hv_b, hv_b, cfg, generator)
        # distance from the (noisy, quantized) packed dot product, zero on
        # the diagonal, clamped at 0; hd_dim + (-s) is hd_dim - s exactly
        dist = scores.neg_().add_(cfg.hd_dim).mul_(0.5)
        dist = dist.fill_diagonal_(0.0).clamp_min_(0.0)
        res = complete_linkage(dist, threshold)
        del scores, dist
        labels[bidx] = bidx[res.labels.cpu().numpy()]

    labels_t = torch.from_numpy(labels.astype(np.int32)).to(dev)
    clustered = float(clustered_spectra_ratio(labels_t))
    incorrect = float(incorrect_clustering_ratio(
        labels_t, _on(identity, dev).to(torch.int32)))
    cost = energy_mod.clustering_cost(
        num_spectra=n, hd_dim=cfg.hd_dim, mlc_bits=cfg.mlc_bits,
        adc_bits=cfg.adc_bits, write_verify=cfg.write_verify,
        material=cfg.material,
    )
    return ClusterReport(
        labels=labels, clustered_ratio=clustered, incorrect_ratio=incorrect,
        num_clusters=len(np.unique(labels)), cost=cost,
    )


# --------------------------------------------------------------------------
# DB search (Fig. 2)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SearchReport:
    matches: np.ndarray          # (Q,) matched reference index (-1 if rejected)
    accepted: np.ndarray         # (Q,) bool — passed FDR
    num_identified: int
    recall: float                # vs ground truth, over accepted
    cost: "energy_mod.CostReport"
    num_no_candidate: int = 0    # queries with an empty precursor window


def query_chunk(num_refs: int) -> int:
    """Queries scored at once against ``num_refs`` rows: the most that
    keep a score matrix within :data:`SCORE_CHUNK_ELEMS`, rounded down to
    a multiple of 32 (the kernel's query tile) where that leaves one."""
    step = max(1, SCORE_CHUNK_ELEMS // max(1, num_refs))
    return step - step % 32 if step >= 32 else step


def run_db_search(
    query_spectra,
    query_precursor,
    ref_spectra,
    ref_precursor,
    cfg: SpecPCMConfig,
    query_identity=None,
    ref_identity=None,
    fdr: float = 0.01,
    open_search: bool = True,
    device: str | torch.device = "cuda",
) -> SearchReport:
    """Full DB search pipeline with decoy competition and FDR filtering,
    on ``device`` (numpy or tensor inputs are moved there).

    Per query: the best target and decoy scores inside its precursor
    window (masked scores are -1e9); the match is the first index of the
    best target; a tie of target and decoy goes to the decoy; a query with
    an empty window is left out of the FDR estimate and reported in
    ``num_no_candidate``."""
    dev = resolve_device(device)
    generator = _generator(cfg.seed + 29, dev)
    ref_sp = _on(ref_spectra, dev).to(torch.float32)
    q_packed = encode_and_pack(_on(query_spectra, dev).to(torch.float32), cfg)
    r_packed = encode_and_pack(ref_sp, cfg)
    d_packed = encode_and_pack(make_decoys(ref_sp), cfg)
    del ref_sp
    # the targets' noise is drawn first, then the decoys'
    targets = _program(r_packed, cfg, generator)
    decoys = _program(d_packed, cfg, generator)
    del r_packed, d_packed
    q_prec = _on(query_precursor, dev).to(torch.float32)
    r_prec = _on(ref_precursor, dev).to(torch.float32)

    Q, R = q_packed.shape[0], targets.shape[0]
    best = torch.empty(Q, dtype=torch.float32, device=dev)
    is_target = torch.empty(Q, dtype=torch.bool, device=dev)
    match_idx = torch.empty(Q, dtype=torch.int64, device=dev)
    has_candidate = torch.empty(Q, dtype=torch.bool, device=dev)
    in_window = torch.zeros((), dtype=torch.int64, device=dev)
    step = query_chunk(R)
    for q0 in range(0, Q, step):
        rows = slice(q0, q0 + step)
        mask = candidate_window_mask(q_prec[rows], r_prec,
                                     open_search=open_search)
        outside = ~mask
        s_t = _scores(q_packed[rows], targets, cfg).masked_fill_(
            outside, MASKED_SCORE)
        best_t = s_t.amax(dim=1)
        match_idx[rows] = s_t.argmax(dim=1)  # the first index of the max
        del s_t
        s_d = _scores(q_packed[rows], decoys, cfg).masked_fill_(
            outside, MASKED_SCORE)
        best_d = s_d.amax(dim=1)
        del s_d, outside
        is_target[rows] = best_t > best_d
        best[rows] = torch.maximum(best_t, best_d)
        has_candidate[rows] = mask.any(dim=1)
        in_window += mask.sum()
        del mask
    accept = fdr_filter(best, is_target, fdr=fdr, valid=has_candidate)

    acc = accept.cpu().numpy()
    match_np = match_idx.to(torch.int32).cpu().numpy()
    matches = np.where(acc, match_np, -1)
    recall = 0.0
    if query_identity is not None and ref_identity is not None:
        qi = _host(query_identity)
        ri = _host(ref_identity)
        good = acc & (ri[match_np] == qi)
        recall = float(good.sum() / max(qi.shape[0], 1))

    cand_frac = mean_of_count(int(in_window), Q * R)
    cost = energy_mod.db_search_cost(
        num_queries=Q, num_refs=R * 2,
        hd_dim=cfg.hd_dim, mlc_bits=cfg.mlc_bits, adc_bits=cfg.adc_bits,
        write_verify=cfg.write_verify, candidate_fraction=max(cand_frac, 1e-4),
        material=cfg.material,
    )
    return SearchReport(
        matches=matches, accepted=acc, num_identified=int(acc.sum()),
        recall=recall, cost=cost,
        num_no_candidate=int((~has_candidate).sum()),
    )
