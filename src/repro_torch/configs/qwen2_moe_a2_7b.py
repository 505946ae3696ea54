"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (MHA kv=16) vocab=151936; MoE: 60 routed experts top-4
(expert d_ff=1408, fine-grained) + 4 shared experts (4*1408=5632 hidden)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ParallelConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408,
                  shard="auto", n_experts_padded=64),
    parallel=ParallelConfig(remat="full", grad_accum=1),
)

SMOKE = ArchConfig(
    name="qwen2-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab=512,
    vocab_pad_multiple=16,
    moe=MoEConfig(n_experts=8, top_k=4, n_shared=2, d_ff_expert=48,
                  group_tokens=64),
)
