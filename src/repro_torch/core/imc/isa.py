"""Instruction Set Architecture for IMC control (SpecPCM §III.F, Table S2),
in PyTorch.

Counterpart of ``repro.core.imc.isa``. Three instructions manage the
memory system:

  STORE_HV   (data, arr_idx, col_addr, row_addr, MLC_bits, write_cycles)
  READ_HV    (data_size, arr_idx, col_addr, row_addr, MLC_bits)
  MVM_COMPUTE(row_addr, num_activated_row, ADC_bits, MLC_bits)

Instructions encode to 64-bit words (fields below) and the
:class:`ISAExecutor` interprets a stream against the array model while
metering energy and latency through :mod:`repro_torch.core.imc.energy`.
``MVM_COMPUTE`` runs :func:`repro_torch.core.imc.array.imc_mvm_reference`,
so on the card it launches the ``imc_mvm`` kernel.

64-bit encoding (LSB-first):
  [0:4]   opcode
  [4:20]  arr_idx       (16 bits)
  [20:28] col_addr      (8 bits)
  [28:44] row_addr / num rows for MVM (16 bits)
  [44:48] mlc_bits      (4 bits)
  [48:54] write_cycles / adc_bits (6 bits)
  [54:64] reserved
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

import numpy as np
import torch

from repro_torch.core.imc import energy as energy_mod
from repro_torch.core.imc.array import (
    ArrayConfig,
    IMCArrayState,
    imc_mvm_reference,
    program_hvs,
)
from repro_torch.core.imc.device import DeviceConfig
from repro_torch.device import resolve_device


class Opcode(enum.IntEnum):
    STORE_HV = 1
    READ_HV = 2
    MVM_COMPUTE = 3


@dataclasses.dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    arr_idx: int = 0
    col_addr: int = 0
    row_addr: int = 0
    mlc_bits: int = 3
    aux: int = 0  # write_cycles for STORE, adc_bits for MVM, data_size for READ

    def __post_init__(self):
        if not (0 <= self.arr_idx < 2**16):
            raise ValueError(f"arr_idx out of range: {self.arr_idx}")
        if not (0 <= self.col_addr < 2**8):
            raise ValueError(f"col_addr out of range: {self.col_addr}")
        if not (0 <= self.row_addr < 2**16):
            raise ValueError(f"row_addr out of range: {self.row_addr}")
        if not (0 <= self.mlc_bits < 2**4):
            raise ValueError(f"mlc_bits out of range: {self.mlc_bits}")
        if not (0 <= self.aux < 2**6):
            raise ValueError(f"aux out of range: {self.aux}")


def encode_instruction(inst: Instruction) -> int:
    w = int(inst.opcode) & 0xF
    w |= (inst.arr_idx & 0xFFFF) << 4
    w |= (inst.col_addr & 0xFF) << 20
    w |= (inst.row_addr & 0xFFFF) << 28
    w |= (inst.mlc_bits & 0xF) << 44
    w |= (inst.aux & 0x3F) << 48
    return w


def decode_instruction(word: int) -> Instruction:
    return Instruction(
        opcode=Opcode(word & 0xF),
        arr_idx=(word >> 4) & 0xFFFF,
        col_addr=(word >> 20) & 0xFF,
        row_addr=(word >> 28) & 0xFFFF,
        mlc_bits=(word >> 44) & 0xF,
        aux=(word >> 48) & 0x3F,
    )


@dataclasses.dataclass
class ExecutionTrace:
    cycles: int = 0
    energy_j: float = 0.0
    instructions: int = 0

    def merge(self, other: "ExecutionTrace") -> "ExecutionTrace":
        return ExecutionTrace(
            cycles=self.cycles + other.cycles,
            energy_j=self.energy_j + other.energy_j,
            instructions=self.instructions + other.instructions,
        )


class ISAExecutor:
    """Interprets an instruction stream against a logical bank of arrays
    on ``device``.

    The executor owns a staging buffer (``stage``: STORE_HV consumes it,
    READ_HV fills it), the programmed bank state (one dense weight matrix
    striped over ceil(packed_dim / cols) arrays) and an ExecutionTrace
    metering cycles and energy by the paper's component model. Each
    STORE_HV draws its write noise from one ``torch.Generator`` seeded with
    ``seed``, in instruction order (the reference splits a threefry key
    per STORE_HV; those draws cannot be reproduced).
    """

    def __init__(self, array_cfg: ArrayConfig, device_cfg: DeviceConfig,
                 hw: "energy_mod.HardwareModel | None" = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.array_cfg = array_cfg
        self.device_cfg = device_cfg
        self.hw = hw or energy_mod.DEFAULT_HW
        self.torch_device = resolve_device(device)
        self.generator = torch.Generator(
            device=self.torch_device).manual_seed(int(seed))
        self.state: IMCArrayState | None = None
        self.stage: torch.Tensor | None = None
        self.result: torch.Tensor | None = None
        self.trace = ExecutionTrace()

    def load_stage(self, packed_hvs) -> None:
        """Host DMA into the staging buffer (not an ISA instruction):
        numpy arrays or tensors, moved to the executor's device."""
        if isinstance(packed_hvs, np.ndarray):
            packed_hvs = torch.from_numpy(packed_hvs)
        self.stage = packed_hvs.to(self.torch_device)

    def execute(self, stream: Iterable[Instruction]) -> ExecutionTrace:
        for inst in stream:
            self.execute_one(inst)
        return self.trace

    def execute_one(self, inst: Instruction) -> None:
        cfg = self.array_cfg
        if inst.opcode == Opcode.STORE_HV:
            if self.stage is None:
                raise RuntimeError("STORE_HV with empty staging buffer")
            dev = dataclasses.replace(
                self.device_cfg,
                bits_per_cell=inst.mlc_bits,
                write_verify_cycles=inst.aux,
            )
            acfg = dataclasses.replace(cfg, bits_per_cell=inst.mlc_bits)
            self.state = program_hvs(self.generator, self.stage, acfg, dev)
            rows, dp = self.stage.shape
            n_arrays = -(-dp // cfg.cols)
            self._meter(energy_mod.program_cycles(self.hw, rows, n_arrays,
                                                  inst.aux),
                        energy_mod.program_energy_j(self.hw, dev, rows * dp,
                                                    inst.aux))
        elif inst.opcode == Opcode.READ_HV:
            if self.state is None:
                raise RuntimeError("READ_HV before STORE_HV")
            rows = max(inst.aux, 1)
            total, dp = self.state.weights.shape
            if rows > total:
                raise ValueError(f"READ_HV of {rows} rows from a bank of "
                                 f"{total}")
            # dynamic_slice_in_dim clamps the start so the slice fits: on a
            # 10-row bank, row_addr 8 with 4 rows reads rows 6-9
            start = min(inst.row_addr, total - rows)
            # torch.round, like jnp.round, rounds half to even
            self.stage = torch.round(
                self.state.weights[start:start + rows]).to(torch.int8)
            self._meter(energy_mod.read_cycles(self.hw, rows),
                        energy_mod.read_energy_j(self.hw, rows * dp))
        elif inst.opcode == Opcode.MVM_COMPUTE:
            if self.state is None or self.stage is None:
                raise RuntimeError("MVM_COMPUTE needs programmed state + "
                                   "staged query")
            # adc_bits 1 leaves no ADC level: the kernel's wrapper raises
            # (the reference divides by zero)
            acfg = dataclasses.replace(
                cfg, adc_bits=max(inst.aux, 1), bits_per_cell=inst.mlc_bits)
            nrow = (inst.row_addr if inst.row_addr > 0
                    else self.state.weights.shape[0])
            w = self.state.weights[:nrow]
            self.result = imc_mvm_reference(self.stage, w, acfg)
            q, dp = self.stage.shape
            n_arrays = -(-dp // cfg.cols)
            self._meter(energy_mod.mvm_cycles(self.hw, q, nrow, n_arrays,
                                              cfg.rows),
                        energy_mod.mvm_energy_j(self.hw, q, nrow, n_arrays,
                                                acfg.adc_bits))
        else:  # pragma: no cover
            raise ValueError(f"unknown opcode {inst.opcode}")

    def _meter(self, cycles: int, energy_j: float) -> None:
        self.trace = self.trace.merge(ExecutionTrace(
            cycles=cycles, energy_j=energy_j, instructions=1))


def compile_db_search(
    num_refs: int,
    packed_dim: int,
    cfg: ArrayConfig,
    write_cycles: int,
    adc_bits: int,
    mlc_bits: int,
) -> list[Instruction]:
    """Tiny 'compiler': DB-search instruction stream = program refs once,
    then one MVM per staged query batch."""
    return [
        Instruction(Opcode.STORE_HV, mlc_bits=mlc_bits, aux=write_cycles),
        Instruction(Opcode.MVM_COMPUTE, row_addr=0, mlc_bits=mlc_bits,
                    aux=adc_bits),
    ]
