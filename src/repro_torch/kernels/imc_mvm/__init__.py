from repro_torch.kernels.imc_mvm.ops import imc_mvm, imc_mvm_plain

__all__ = ["imc_mvm", "imc_mvm_plain"]
