"""hubert-xlarge [arXiv:2106.07447; unverified]
48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504.
Encoder-only (bidirectional, LayerNorm, GeLU MLP, no GLU): no decoder, so
the serve engines refuse it. The conv feature-extractor frontend is a
stub: ``Model.apply`` takes precomputed frame embeddings ``frames`` (B, S,
1280) through one (1280, 1280) projection."""
from repro_torch.configs.base import ArchConfig, ParallelConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    vocab_pad_multiple=8,  # 504 -> 504 (already /8); head divisibility n/a
    act="gelu",
    glu=False,
    norm="ln",
    causal=False,
    has_decoder=False,
    parallel=ParallelConfig(remat="full"),
)

SMOKE = ArchConfig(
    name="hubert-smoke",
    family="encoder",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=56,
    vocab_pad_multiple=8,
    act="gelu",
    glu=False,
    norm="ln",
    causal=False,
    has_decoder=False,
)
