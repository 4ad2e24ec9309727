"""Energy/latency model of the SpecPCM chip (Tables 1, 2, 3, S3), copied
for the PyTorch port.

Counterpart of ``repro.core.imc.energy``: plain Python, the same
numbers. It models the paper's PCM chip, not the card the port runs on:
its latencies and energies are the modelled chip's.

Component model (Table S3, 40 nm, 500 MHz — one 128x128 array macro):

  component        total power (mW)
  PCM array        3.58
  flash ADC (16u)  5.12      <- scales with enabled comparators (2^b - 1)/63
  DAC (128u)       0.84
  SL gen/drive     3.36
  read gen         0.51
  WL dec/drive     1.04
  sense amp        0.64
  selectors        0.50
  ----------------------------
  total            15.59 mW, 0.0402 mm^2

Operation timing (§III.C / §S.B): one whole-array IMC MVM (128 refs x 128
packed dims) takes 10 cycles = 20 ns, including DAC input generation; each
ADC digitizes 8 rows in 8 of those cycles. Programming one row of one array
takes 10 cycles = 20 ns per write-verify pass.

Workload mapping (§III.C):
  * an HV of packed length D' stripes over ceil(D'/128) arrays,
  * 128 HVs share an array row-group,
  * DB search: refs programmed once (amortized); each query performs
    ceil(candidates/128) * stripes array-MVMs,
  * clustering: per bucket of size m — program m rows, m MVMs against the
    bucket (distance matrix), then ~merge_fraction*m serial complete-linkage
    merges handled by the near-memory ASIC.

Calibration constants (marked CAL below) are fitted once against the paper's
own reported latency/energy (Tables 2/3) and then *held fixed* across
datasets (the reference's tests hold every published cell within 10-15%).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.imc.device import DeviceConfig


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    clock_hz: float = 500e6
    array_rows: int = 128
    array_cols: int = 128
    cycles_per_mvm: int = 10        # whole-array IMC op incl. DAC setup
    cycles_per_program: int = 10    # one row, one write pass
    cycles_per_read: int = 10       # one row normal read
    # Table S3 totals, per array macro (mW)
    p_array_mw: float = 3.58
    p_adc_mw: float = 5.12          # at 6-bit (63 comparators)
    p_dac_mw: float = 0.84
    p_sl_mw: float = 3.36
    p_readgen_mw: float = 0.51
    p_wl_mw: float = 1.04
    p_senseamp_mw: float = 0.64
    p_sel_mw: float = 0.50
    area_mm2: float = 0.0402
    # chip-level organization
    parallel_arrays: int = 32       # CAL: arrays operating concurrently
    merge_cycles_per_block: int = 43  # CAL: ASIC cycles per 128-wide distance block per merge
    adc_ref_bits: int = 6

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.clock_hz

    def macro_power_w(self, adc_bits: int) -> float:
        """Macro power with the ADC partially enabled (§IV.B(4): 4-bit flash
        ADC ~4x cheaper than 6-bit — comparator count (2^b - 1) scaling)."""
        adc_scale = (2**adc_bits - 1) / (2**self.adc_ref_bits - 1)
        total_mw = (
            self.p_array_mw
            + self.p_adc_mw * adc_scale
            + self.p_dac_mw
            + self.p_sl_mw
            + self.p_readgen_mw
            + self.p_wl_mw
            + self.p_senseamp_mw
            + self.p_sel_mw
        )
        return total_mw * 1e-3

    def mvm_op_energy_j(self, adc_bits: int) -> float:
        return self.macro_power_w(adc_bits) * self.cycles_per_mvm * self.cycle_s


DEFAULT_HW = HardwareModel()


# --------------------------------------------------------------------------
# primitive op metering (used by the ISA executor)
# --------------------------------------------------------------------------

def stripes(packed_dim: int, hw: HardwareModel = DEFAULT_HW) -> int:
    return -(-packed_dim // hw.array_cols)


def mvm_cycles(hw: HardwareModel, n_queries: int, n_rows: int, n_stripes: int,
               rows_per_array: int | None = None) -> int:
    rpa = rows_per_array or hw.array_rows
    row_groups = -(-n_rows // rpa)
    ops = n_queries * row_groups * n_stripes
    seq = -(-ops // hw.parallel_arrays)
    return seq * hw.cycles_per_mvm


def mvm_energy_j(hw: HardwareModel, n_queries: int, n_rows: int,
                 n_stripes: int, adc_bits: int) -> float:
    row_groups = -(-n_rows // hw.array_rows)
    ops = n_queries * row_groups * n_stripes
    return ops * hw.mvm_op_energy_j(adc_bits)


def program_cycles(hw: HardwareModel, n_rows: int, n_stripes: int,
                   write_verify: int) -> int:
    ops = n_rows * n_stripes * (1 + write_verify)
    seq = -(-ops // hw.parallel_arrays)
    return seq * hw.cycles_per_program


def program_energy_j(hw: HardwareModel, dev: DeviceConfig, n_cells: int,
                     write_verify: int) -> float:
    cell_j = dev.pcm.programming_energy_pj * 1e-12 * n_cells * (1 + write_verify)
    # periphery (SL and WL drive) active during programming
    n_rows_ops = n_cells / hw.array_cols * (1 + write_verify)
    peri_j = (
        (hw.p_sl_mw + hw.p_wl_mw + hw.p_sel_mw) * 1e-3
        * hw.cycles_per_program * hw.cycle_s * n_rows_ops
    )
    return cell_j + peri_j


def read_cycles(hw: HardwareModel, n_rows: int) -> int:
    seq = -(-n_rows // hw.parallel_arrays)
    return seq * hw.cycles_per_read


def read_energy_j(hw: HardwareModel, n_cells: int) -> float:
    n_row_ops = n_cells / hw.array_cols
    return (
        (hw.p_readgen_mw + hw.p_senseamp_mw + hw.p_wl_mw + hw.p_sel_mw) * 1e-3
        * hw.cycles_per_read * hw.cycle_s * n_row_ops
    )


# --------------------------------------------------------------------------
# workload-level analytic costs (Tables 2 & 3)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CostReport:
    latency_s: float
    energy_j: float
    breakdown: dict[str, float]

    def speedup_vs(self, baseline_latency_s: float) -> float:
        return baseline_latency_s / self.latency_s


def clustering_cost(
    num_spectra: int,
    hd_dim: int = 2048,
    mlc_bits: int = 3,
    adc_bits: int = 6,
    write_verify: int = 0,
    bucket_size: int = 10_624,       # CAL: avg precursor-m/z bucket
    merge_fraction: float = 0.6,     # ~clustered-spectra ratio (Fig. 9)
    material: str = "sb2te3",
    hw: HardwareModel = DEFAULT_HW,
) -> CostReport:
    """End-to-end spectral clustering cost (paper Table 2 workload).

    Phases: (1) program bucket HVs, (2) all-pairs distance MVMs (parallel
    across arrays), (3) serial complete-linkage merge loop in the ASIC with
    distance-row updates written back to PCM.
    """
    dev = DeviceConfig(material=material, bits_per_cell=mlc_bits,
                       write_verify_cycles=write_verify)
    dp = -(-hd_dim // mlc_bits)
    nst = stripes(dp, hw)
    n_buckets = max(1, round(num_spectra / bucket_size))
    m = num_spectra / n_buckets  # actual bucket size

    # (1) programming: every spectrum row once, all stripes
    prog_cyc = program_cycles(hw, num_spectra, nst, write_verify)
    prog_j = program_energy_j(hw, dev, num_spectra * dp, write_verify)

    # (2) distance matrix: per bucket, m queries against m rows
    row_groups = -(-int(m) // hw.array_rows)
    mvm_ops = num_spectra * row_groups * nst  # sum over buckets of m * rg * nst
    mvm_cyc = -(-mvm_ops // hw.parallel_arrays) * hw.cycles_per_mvm
    mvm_j = mvm_ops * hw.mvm_op_energy_j(adc_bits)

    # (3) serial merge loop: per merge, scan + update one distance row of
    # length m in 128-wide blocks
    n_merges = int(merge_fraction * num_spectra)
    merge_cyc = n_merges * row_groups * hw.merge_cycles_per_block
    # near-memory ASIC merge logic is a tiny digital block (69 um^2, <0.5% of
    # the macro area — §S.B) — ~0.5 mW of switching power at 500 MHz
    merge_j = 0.5e-3 * merge_cyc * hw.cycle_s
    # distance-row write-back on merge
    merge_prog_j = program_energy_j(hw, dev, n_merges * row_groups * hw.array_cols, 0)

    cyc = prog_cyc + mvm_cyc + merge_cyc
    lat = cyc * hw.cycle_s
    en = prog_j + mvm_j + merge_j + merge_prog_j
    return CostReport(
        latency_s=lat,
        energy_j=en,
        breakdown={
            "program_s": prog_cyc * hw.cycle_s,
            "distance_mvm_s": mvm_cyc * hw.cycle_s,
            "merge_s": merge_cyc * hw.cycle_s,
            "program_j": prog_j,
            "distance_mvm_j": mvm_j,
            "merge_j": merge_j + merge_prog_j,
        },
    )


def db_search_cost(
    num_queries: int,
    num_refs: int,
    hd_dim: int = 8192,
    mlc_bits: int = 3,
    adc_bits: int = 6,
    write_verify: int = 3,
    candidate_fraction: float = 0.02,  # precursor-window filtering (per dataset)
    material: str = "tite2",
    include_programming: bool = False,  # refs amortized (paper §IV.B(3))
    hw: HardwareModel = DEFAULT_HW,
) -> CostReport:
    """DB search cost (paper Table 3 workload)."""
    dev = DeviceConfig(material=material, bits_per_cell=mlc_bits,
                       write_verify_cycles=write_verify)
    dp = -(-hd_dim // mlc_bits)
    nst = stripes(dp, hw)
    cands = max(1, int(candidate_fraction * num_refs))
    row_groups = -(-cands // hw.array_rows)
    # per query: row_groups * nst array ops, queries stream through
    ops = num_queries * row_groups * nst
    cyc = -(-ops // hw.parallel_arrays) * hw.cycles_per_mvm
    en = ops * hw.mvm_op_energy_j(adc_bits)
    breakdown = {"search_s": cyc * hw.cycle_s, "search_j": en}
    if include_programming:
        pc = program_cycles(hw, num_refs, nst, write_verify)
        pj = program_energy_j(hw, dev, num_refs * dp, write_verify)
        cyc += pc
        en += pj
        breakdown.update({"program_s": pc * hw.cycle_s, "program_j": pj})
    return CostReport(latency_s=cyc * hw.cycle_s, energy_j=en, breakdown=breakdown)


# Published baselines for the speedup tables (paper Tables 2/3)
PAPER_TABLE2 = {
    "PXD001468": {"Falcon(CPU)": 573.0, "msCRUSH(CPU)": 358.0,
                  "HyperSpec(GPU)": 38.0, "SpecHD(FPGA)": 13.17,
                  "SpecPCM(paper)": 5.46},
    "PXD000561": {"Falcon(CPU)": 134 * 60.0, "msCRUSH(CPU)": 42 * 60.0,
                  "HyperSpec(GPU)": 17 * 60.0, "SpecHD(FPGA)": 179.0,
                  "SpecPCM(paper)": 98.4},
}
PAPER_TABLE3 = {
    "iPRG2012": {"ANN-SoLo(CPU-GPU)": 6.45, "HyperOMS(GPU)": 2.08,
                 "RRAM(130nm)": 1.22, "3DNAND(7nm)": 0.145,
                 "SpecPCM(paper)": 0.049},
    "HEK293": {"ANN-SoLo(CPU-GPU)": 45.14, "HyperOMS(GPU)": 10.4,
               "SpecPCM(paper)": 0.316},
}
PAPER_ENERGY = {"PXD000561_clustering_j": 3.27, "HEK293_db_search_j": 0.149}

# Dataset scale constants (paper §S.A)
DATASETS = {
    "PXD001468": {"num_spectra": 1_100_000},
    "PXD000561": {"num_spectra": 21_100_000},
    "iPRG2012": {"num_queries": 15_867, "num_refs": 1_162_392,
                 "candidate_fraction": 0.025},
    "HEK293": {"num_queries": 46_665, "num_refs": 2_992_672,
               "candidate_fraction": 0.02},
}
