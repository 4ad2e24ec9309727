"""The analog PCM in-memory-compute model, in PyTorch: devices and write
noise (``device``), the array's DAC / MVM / ADC chain on the ``imc_mvm``
kernel (``array``), the control ISA (``isa``) and the chip's energy and
latency model (``energy``). Counterpart of ``repro.core.imc``."""

from repro_torch.core.imc.array import (
    ArrayConfig,
    IMCArrayState,
    adc_quantize,
    dac_quantize,
    imc_mvm,
    imc_mvm_reference,
    program_hvs,
)
from repro_torch.core.imc.device import (
    MATERIALS,
    SB2TE3_GST,
    TITE2_GST,
    DeviceConfig,
    PCMMaterial,
    apply_write_noise,
    bit_error_rate,
    noise_sigma,
)
from repro_torch.core.imc.energy import (
    DEFAULT_HW,
    HardwareModel,
    clustering_cost,
    db_search_cost,
)
from repro_torch.core.imc.isa import (
    Instruction,
    ISAExecutor,
    Opcode,
    decode_instruction,
    encode_instruction,
)

__all__ = [
    "PCMMaterial", "SB2TE3_GST", "TITE2_GST", "MATERIALS",
    "DeviceConfig", "noise_sigma", "bit_error_rate", "apply_write_noise",
    "ArrayConfig", "IMCArrayState", "program_hvs", "imc_mvm",
    "imc_mvm_reference", "adc_quantize", "dac_quantize",
    "Opcode", "Instruction", "encode_instruction", "decode_instruction",
    "ISAExecutor",
    "HardwareModel", "DEFAULT_HW", "clustering_cost", "db_search_cost",
]
