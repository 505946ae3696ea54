"""SWIS core: quantization, selection, scheduling, packing (the paper's
primary contribution; PyTorch port of ``repro.core``)."""
from repro_torch.core.swis import QuantConfig, QuantizedWeight, quantize, fake_quant, act_truncate, rmse
from repro_torch.core.packing import PackedWeight, pack, unpack_dense, compression_ratio
from repro_torch.core.qat import ste_quant, maybe_quant
from repro_torch.core import probability, selection, scheduling

__all__ = [
    "QuantConfig", "QuantizedWeight", "quantize", "fake_quant", "act_truncate",
    "rmse", "PackedWeight", "pack", "unpack_dense", "compression_ratio",
    "ste_quant", "maybe_quant", "probability", "selection", "scheduling",
]
