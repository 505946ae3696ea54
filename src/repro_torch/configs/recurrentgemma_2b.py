"""recurrentgemma-2b [arXiv:2402.19427; hf]
26L d_model=2560 10H (MQA kv=1, d_head=256) d_ff=7680 vocab=256000.
RG-LRU + local attention, pattern (rec, rec, attn) — 8 stacked units + 2
tail rec layers. Sub-quadratic (bounded window + O(1) recurrent state)."""
from repro_torch.configs.base import ArchConfig, GriffinConfig, ParallelConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="griffin",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256000,
    act="gelu",
    tie_embeddings=True,  # Gemma family ties input/output embeddings
    griffin=GriffinConfig(lru_width=2560, conv_width=4, window=2048,
                          pattern=("rec", "rec", "attn_local")),
    sub_quadratic=True,
    parallel=ParallelConfig(remat="full"),
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    family="griffin",
    n_layers=4,  # one stacked (rec, rec, attn_local) unit + one tail rec
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_head=16,
    d_ff=128,
    vocab=512,
    vocab_pad_multiple=16,
    act="gelu",
    griffin=GriffinConfig(lru_width=64, conv_width=4, window=8,
                          pattern=("rec", "rec", "attn_local")),
    sub_quadratic=True,
)
