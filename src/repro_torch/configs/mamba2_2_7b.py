"""mamba2-2.7b [arXiv:2405.21060; unverified]
64L d_model=2560 attn-free (SSD, state=128, head_dim=64, expand=2)
vocab=50280 (padded to 50432 for sharding divisibility). Sub-quadratic:
O(1) recurrent state carries the long_500k decode shape."""
from repro_torch.configs.base import ArchConfig, Mamba2Config, ParallelConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="mamba2",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # attention-free; kept for config uniformity
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    vocab_pad_multiple=128,  # 50280 -> 50432 (divisible by 16 TP shards)
    glu=False,
    mamba2=Mamba2Config(d_state=128, head_dim=64, expand=2, chunk=256),
    sub_quadratic=True,
    parallel=ParallelConfig(remat="full"),
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="mamba2",
    n_layers=3,
    d_model=64,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab=512,
    vocab_pad_multiple=16,
    glu=False,
    mamba2=Mamba2Config(d_state=16, head_dim=16, expand=2, chunk=16),
    sub_quadratic=True,
)
