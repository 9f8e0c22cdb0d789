"""Model / run configuration system.

A single `ModelConfig` dataclass describes every assigned architecture; family-
specific behaviour is selected by `family` + per-layer `LayerKind` pattern. The
config is the only compile-time construct consumed by the model builder, the
launcher and the dry-run — mirroring the paper's single-JSON-config philosophy
(paper §II.B: "A JSON configuration file is the only compile-time construct
consumed by the compiler, runtime, as well as all hardware targets").
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Layer kinds: the repeating pattern unit of an architecture.
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "attn_global"      # full causal attention
ATTN_LOCAL = "attn_local"        # sliding-window causal attention
RWKV6 = "rwkv6"                  # RWKV-6 time-mix (attention-free)
RGLRU = "rglru"                  # Griffin RG-LRU recurrent block

LAYER_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, RWKV6, RGLRU)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None       # window for ATTN_LOCAL layers
    query_scale: Optional[float] = None        # override head_dim**-0.5
    rope_theta: float = 1e6
    mrope_sections: Optional[Sequence[int]] = None  # qwen2-vl M-RoPE

    # layer pattern: repeating unit of LayerKinds; tiles to n_layers
    pattern: Sequence[str] = (ATTN_GLOBAL,)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25

    # recurrent (rwkv6 / rglru)
    lru_width: int = 0           # RG-LRU recurrence width (griffin)
    conv1d_width: int = 4        # temporal conv in griffin recurrent block
    rwkv_head_dim: int = 64

    # audio (musicgen)
    n_codebooks: int = 0

    # vlm
    vision_stub: bool = False    # input is precomputed embeddings

    # mlp / embedding flavour
    mlp_act: str = "silu"        # silu | gelu
    emb_scale: bool = False      # gemma-style sqrt(d_model) embedding scale

    # distribution/perf knobs (see EXPERIMENTS.md §Perf)
    repeat_kv: bool = True       # expand GQA kv to full heads (train/prefill):
                                 # keeps attention uniformly heads-sharded (no
                                 # SPMD regroup/replication) at G x kv bytes
    grad_accum: int = 1          # microbatches per train step (global batch
                                 # is preserved; bounds live activations)
    unroll_layers: bool = False  # place all layers outside the scan (used by
                                 # the dry-run's depth-1/2 cost probes, where
                                 # while-loop bodies must not hide trip counts)
    moe_shard_tokens: bool = False  # shard MoE dispatch buffers over the
                                 # batch axes along the capacity dim instead
                                 # of d_model (§Perf hypothesis M1)

    # numerics / scheduling
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32" # master params
    remat: bool = True
    attn_chunk: int = 1024       # unrolled q-chunk size for train/prefill attention
    scan_chunk: int = 256        # unrolled time-chunk for rwkv6 wkv
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_norms: bool = False     # gemma2-style post-attention/post-ffn norms
    remat_policy: str = "full"   # full | dots | none  (per-group checkpoint)
    norm_upcast: bool = True     # f32-materialized RMSNorm (False: f32
                                 # reduction, bf16 apply — see §Perf)
    loss_chunks: int = 8         # seq chunks for the fused LM-head loss
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (quantized KV cache:
                                 # halves decode cache bytes; KIVI-style,
                                 # fixed-scale symmetric quantization)

    # ------------------------------------------------------------------
    def __post_init__(self):
        for k in self.pattern:
            assert k in LAYER_KINDS, f"unknown layer kind {k}"
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0 and self.moe_d_ff > 0

    @property
    def layer_kinds(self) -> list[str]:
        """Full per-layer kind list (pattern tiled, truncated to n_layers)."""
        reps = -(-self.n_layers // len(self.pattern))
        return (list(self.pattern) * reps)[: self.n_layers]

    @property
    def n_groups(self) -> int:
        """Number of scanned repeating groups (0 when unrolled)."""
        if self.unroll_layers:
            return 0
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def attention_free(self) -> bool:
        return all(k in (RWKV6, RGLRU) for k in self.layer_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does full-length quadratic attention at 500k
        prefill... used only for the long_500k skip rule (decode is linear for
        all archs, but pure full-attention archs are skipped per spec)."""
        return all(k != ATTN_GLOBAL for k in self.layer_kinds)

    @property
    def long_context_capable(self) -> bool:
        """long_500k policy (see DESIGN.md §4): SSM / hybrid / windowed-attn
        archs run it; gemma2's alternating local/global also runs (decode is
        linear in KV length); pure full-attention archs skip."""
        if self.sub_quadratic:
            return True
        # alternating local/global (gemma2): at most half the layers global
        kinds = self.layer_kinds
        return kinds.count(ATTN_GLOBAL) <= len(kinds) // 2

    def param_count(self) -> int:
        """Analytical parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d  # embed
        if self.n_codebooks:
            total *= self.n_codebooks  # musicgen: K codebook embeds + K heads
        if not self.tie_embeddings:
            total += self.vocab_size * d * max(1, self.n_codebooks)
        for kind in self.layer_kinds:
            total += d  # input norm
            if self.post_norms:
                total += d
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                if self.qkv_bias:
                    attn += (n_q + 2 * n_kv) * hd
                total += attn
            elif kind == RWKV6:
                c = d
                total += 4 * c * c  # r,k,v,g (approx; lora terms counted below)
                total += c * c      # output
                total += 5 * c * 32 * 2 + c * 64 * 2  # ddlerp + decay loras
            elif kind == RGLRU:
                w = self.lru_width or d
                total += 2 * d * w + w * d + self.conv1d_width * w + 2 * w
            # ffn
            total += d  # pre-ffn norm
            if self.post_norms:
                total += d
            if self.family == "moe" and kind != RGLRU:
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * self.moe_d_ff
            elif kind == RWKV6:
                total += d * self.d_ff + self.d_ff * d + d * d  # channel mix
            else:
                total += 3 * d * self.d_ff
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (= total for dense; routed subset for MoE)."""
        if self.family != "moe":
            return self.param_count()
        dense_moe = self.n_experts * 3 * self.d_model * self.moe_d_ff
        active_moe = self.top_k * 3 * self.d_model * self.moe_d_ff
        return int(self.param_count() - self.n_layers * (dense_moe - active_moe))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
