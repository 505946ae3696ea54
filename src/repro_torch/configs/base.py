"""Architecture + run configuration (PyTorch port of ``repro.configs.base``).

One :class:`ArchConfig` instance fully describes a model (family, dims,
per-family extras), its quantization policy (the paper's technique as a
first-class feature), and its parallelism knobs. Every ported architecture
provides a module in this package exposing ``CONFIG`` (exact published dims)
and ``SMOKE`` (reduced same-family config for CPU tests).

The dataclasses keep the reference's field names and defaults, so a config
can be rebuilt field for field on either side of the parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.swis import QuantConfig

FAMILIES = ("dense", "moe", "griffin", "mamba2", "encoder", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0  # always-on shared experts (DeepSeek/Qwen style)
    d_ff_expert: int = 0  # per-expert hidden (0 => use arch d_ff)
    capacity_factor: float = 1.25
    group_tokens: int = 512  # GShard-style dispatch group size
    router_aux_weight: float = 0.01
    # 'ep'   : experts sharded over the model axis (needs E % model == 0)
    # 'tp'   : expert d_ff sharded over the model axis
    # 'auto' : ep when divisible else tp
    shard: str = "auto"
    # Pad the expert count to this value (0 = off) so EP divides the mesh
    # model axis; padded experts get -inf router logits and are never
    # routed. Beyond-paper optimization (see EXPERIMENTS.md §Perf): avoids
    # the TP fallback's full-dispatch-tensor all-reduces.
    n_experts_padded: int = 0

    @property
    def e_total(self) -> int:
        return max(self.n_experts_padded, self.n_experts)


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    lru_width: int = 2560
    conv_width: int = 4
    window: int = 2048  # local attention window
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_c: float = 8.0


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    cross_every: int = 5  # a cross-attn block after every N-th self block
    n_patches: int = 1024  # stub frontend: precomputed patch embeddings
    vision_dim: int = 4096  # dim of the (projected) patch embeddings


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    remat: str = "full"  # 'none' | 'full' | 'dots'
    scan_layers: bool = True
    grad_accum: int = 1
    sp: bool = True  # sequence-shard residuals over the model axis
    fsdp_params: bool = False  # additionally shard params over data axis
    fsdp_opt: bool = True  # shard optimizer state over data axis
    grad_compress: bool = False  # int8-compressed gradient all-reduce


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    cfg: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    mode: str = "off"  # 'off' | 'qat' | 'ptq'
    quantize_embeddings: bool = False
    # Stripes-like baseline: per-layer LSB truncation of 8-bit activations
    # before every GEMM (paper §5 'Act. Trunc.'). 0 = off.
    act_shifts: int = 0
    # Truncated-precision execution over SWIS-packed weights: evaluate
    # only the k most significant bit-slices of every packed GEMM (the
    # bit-serial PE ends its shift-accumulate loop k slices in). None =
    # full precision. The serve engine's self-speculative draft model is
    # the same packed params under a policy with keep_slices set.
    keep_slices: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 0  # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"  # 'silu' (SwiGLU) | 'gelu' (GeGLU or plain)
    glu: bool = True
    norm: str = "rms"  # 'rms' | 'ln'
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128
    causal: bool = True
    moe: Optional[MoEConfig] = None
    griffin: Optional[GriffinConfig] = None
    mamba2: Optional[Mamba2Config] = None
    vlm: Optional[VLMConfig] = None
    quant: QuantPolicy = dataclasses.field(default_factory=QuantPolicy)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention memory: KV-chunked online-softmax block size
    attn_chunk: int = 1024
    # which shapes are valid for this arch ('train', 'prefill', 'decode', 'long')
    sub_quadratic: bool = False  # True => long_500k is runnable
    has_decoder: bool = True  # False for encoder-only (no decode shapes)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family}")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (arch x shape) cell of the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a shape cell applies to this arch (per-assignment skips)."""
    if shape.kind == "decode" and not arch.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (see DESIGN.md)"
    return True, ""
