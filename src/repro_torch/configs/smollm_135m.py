"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
This is the ~100M-class arch used by the end-to-end QAT training example."""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    parallel=ParallelConfig(remat="full"),
)

SMOKE = ArchConfig(
    name="smollm-smoke",
    family="dense",
    n_layers=3,
    d_model=60,
    n_heads=3,
    n_kv_heads=3,
    d_ff=160,
    vocab=512,
    vocab_pad_multiple=16,
    tie_embeddings=True,
)
