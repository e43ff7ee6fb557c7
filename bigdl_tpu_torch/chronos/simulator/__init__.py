"""chronos.simulator of the port (ref: P:chronos/simulator —
DPGANSimulator)."""

from bigdl_tpu_torch.chronos.simulator.dpgan import DPGANSimulator

__all__ = ["DPGANSimulator"]
