"""Model/run configuration system (the port's copy of ``repro.configs.base``).

One frozen dataclass describes everything the model zoo needs; each
architecture gets a module in ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (the exact published shape) and ``smoke_config()`` (a reduced
same-family variant for CPU tests). ``repro_torch.configs.registry``
resolves ``--arch`` names for the architectures ported so far.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "local_attn", "cross_attn", "rglru", "rwkv6"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (attention blocks)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---------------------------------------------------------
    rope: bool = True
    rope_theta: float = 10_000.0
    qkv_bias: bool = False           # qwen1.5
    window: int = 0                  # sliding-window size; 0 = full (starcoder2: 4096)
    causal: bool = True              # hubert: False (encoder-only)
    is_encoder: bool = False
    # Pad Q heads to this count for TP divisibility (zero heads are exact:
    # their wo rows are zero). arctic: 56 -> 64 on a 16-wide model axis.
    pad_heads_to: int = 0

    # --- ffn ----------------------------------------------------------------
    activation: str = "swiglu"       # swiglu | geglu | gelu | squared_relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN parallel to MoE

    # --- recurrent mixers ----------------------------------------------------
    rnn_width: int = 0               # RG-LRU width (0 -> d_model)
    conv_width: int = 4              # Griffin temporal conv
    rwkv_head_size: int = 64
    rwkv_chunk: int = 0              # 0 = sequential scan; >0 = chunked form

    # --- block pattern --------------------------------------------------------
    # Repeated cyclically to n_layers; remainder layers appended at the end.
    block_pattern: tuple[str, ...] = ("attn",)

    # --- stub frontends (audio/vlm: precomputed embeddings per the brief) ----
    frontend: str = ""               # "" | "audio" | "vision"
    num_media_tokens: int = 0        # cross-attn memory length (vlm)

    # --- embeddings / numerics ----------------------------------------------
    tied_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full (save nothing) | dots (save matmul outputs)
    # dry-run cost-extrapolation knobs (XLA cost analysis ignores `while`
    # trip counts, so small variants are lowered UNROLLED; see launch/dryrun)
    unroll_layers: bool = False
    flash_unroll: bool = False

    # --- training defaults ----------------------------------------------------
    optimizer: str = "adamw"         # adamw | adafactor
    moment_dtype: str = "float32"    # bf16 moments for the giant MoEs
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # -- derived -------------------------------------------------------------

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """The per-layer block kinds, pattern cycled to n_layers."""
        pat = self.block_pattern
        reps = self.n_layers // len(pat)
        rem = self.n_layers % len(pat)
        return pat * reps + pat[:rem]

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1) in context length (window/recurrent),
        i.e. the arch can run the long_500k shape."""
        kinds = set(self.layer_kinds)
        if "attn" in kinds and self.window == 0:
            return False
        if "cross_attn" in kinds:
            return False
        return True

    @property
    def supports_decode(self) -> bool:
        return self.causal and not self.is_encoder

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d  # token embedding
        if not self.tied_embeddings:
            total += v * d
        total += d  # final norm
        hd = self.head_dim
        for kind in self.layer_kinds:
            total += 2 * d  # two norms (approx; layernorm bias ignored)
            if kind in ("attn", "local_attn", "cross_attn"):
                total += d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
            elif kind == "rglru":
                w = self.rnn_width
                total += 2 * d * w + self.conv_width * w + 2 * w * (w // 8) + 2 * w + w * d
            elif kind == "rwkv6":
                total += 4 * d * d + d * d  # r,k,v,g,o
                total += 6 * d * 64  # lora mixers (approx)
            if kind == "cross_attn":
                pass
            if self.n_experts and kind != "rwkv6":
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * f
                if self.moe_dense_residual:
                    total += 3 * d * f
            elif kind == "rwkv6":
                total += 2 * d * f // 2 + d * d  # channel mix (k, v, r)
            else:
                mult = 3 if self.activation in ("swiglu", "geglu") else 2
                total += mult * d * f
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_layer_all = self.n_experts * 3 * d * f
        per_layer_active = self.top_k * 3 * d * f
        n_moe_layers = sum(1 for k in self.layer_kinds if k != "rwkv6")
        return self.param_count() - n_moe_layers * (per_layer_all - per_layer_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
