"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
88L d_model=12288 96H (GQA kv=8, d_head=128) d_ff=28672 vocab=32768."""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=32768,
    parallel=ParallelConfig(remat="full", grad_accum=16, fsdp_params=True),
)

SMOKE = ArchConfig(
    name="mistral-large-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_head=16,
    d_ff=192,
    vocab=512,
    vocab_pad_multiple=16,
)
