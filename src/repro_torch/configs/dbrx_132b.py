"""dbrx-132b [hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352; MoE 16 experts top-4."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, d_ff_expert=10752,
                  shard="auto"),
    parallel=ParallelConfig(remat="full", grad_accum=4, fsdp_params=True),
)

SMOKE = ArchConfig(
    name="dbrx-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=96,
    vocab=512,
    vocab_pad_multiple=16,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=96,
                  group_tokens=64),
)
