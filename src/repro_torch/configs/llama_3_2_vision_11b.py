"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; gated cross-attn
image layers every 5th block. The vision frontend is a stub: a request's
``extra={"patches": ...}`` carries precomputed, projected patch embeddings
(1024, 4096), which only prefill launches read."""
from repro_torch.configs.base import ArchConfig, ParallelConfig, VLMConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    vlm=VLMConfig(cross_every=5, n_patches=1024, vision_dim=4096),
    parallel=ParallelConfig(remat="full", grad_accum=2),
)

SMOKE = ArchConfig(
    name="llama-vision-smoke",
    family="vlm",
    n_layers=4,  # two (attn, self_cross) units
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    vocab_pad_multiple=16,
    vlm=VLMConfig(cross_every=2, n_patches=16, vision_dim=64),
)
