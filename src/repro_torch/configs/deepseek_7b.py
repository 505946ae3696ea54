"""deepseek-7b [arXiv:2401.02954; hf]
30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400, llama arch."""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    parallel=ParallelConfig(remat="full"),
)

SMOKE = ArchConfig(
    name="deepseek-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=176,
    vocab=512,
    vocab_pad_multiple=16,
)
