"""Optimizer substrate of the port (PyTorch port of ``repro.optim``):
plain functions over nested parameter dicts, fp32 moments, no
``torch.optim``."""
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compress import (compressed_allreduce,
                                        dequantize_grads,
                                        quantize_grads_int8)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear

__all__ = ["AdamW", "warmup_cosine", "warmup_linear", "clip_by_global_norm",
           "global_norm", "quantize_grads_int8", "dequantize_grads",
           "compressed_allreduce"]
