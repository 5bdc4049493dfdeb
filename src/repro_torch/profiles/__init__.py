from repro_torch.profiles.perf_model import H100, HardwareSpec, PerfModel, V5E

__all__ = ["H100", "HardwareSpec", "PerfModel", "V5E"]
