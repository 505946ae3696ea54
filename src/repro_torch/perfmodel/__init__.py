"""Analytical performance model of the paper's accelerator (port of
``repro.perfmodel``): the bit-serial PE constants (``pe``), an
output-stationary systolic-array simulator (``systolic``, SCALE-Sim-like)
over the paper's conv networks (``networks``), and the Table-4, Fig.-1 and
headline-ratio evaluation (``evaluate``). Pure Python: its figures are
predictions for the paper's 28 nm design, not measurements of any chip.
The serve cost model reads the PE constants."""
from repro_torch.perfmodel.pe import PEConfig, PE_LIBRARY
from repro_torch.perfmodel.systolic import (SystolicArray, LayerShape,
                                            simulate_layer, simulate_network)
from repro_torch.perfmodel.networks import NETWORKS

__all__ = ["PEConfig", "PE_LIBRARY", "SystolicArray", "LayerShape",
           "simulate_layer", "simulate_network", "NETWORKS"]
