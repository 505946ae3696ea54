"""phi3-mini-3.8b [arXiv:2404.14219; unverified]
32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064. RoPE SwiGLU."""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    parallel=ParallelConfig(remat="full"),
)

SMOKE = ArchConfig(
    name="phi3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=512,
    vocab_pad_multiple=16,
)
