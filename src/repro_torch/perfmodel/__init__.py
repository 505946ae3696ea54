"""Analytical performance model of the paper's bit-serial PEs (port of
``repro.perfmodel``). Only the PE constants (``pe``) are ported so far:
the serve cost model needs them; the systolic-array simulator and the
network tables come with the paper-table benchmarks."""
from repro_torch.perfmodel.pe import PE_LIBRARY, PEConfig

__all__ = ["PEConfig", "PE_LIBRARY"]
