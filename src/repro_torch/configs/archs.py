"""The 10 assigned architectures (exact configs from the assignment block)
plus reduced smoke variants for CPU tests.

Sources are recorded per-arch; parameters not pinned by the assignment line
(e.g. head_dim) follow the public model card cited in the assignment.
"""
from __future__ import annotations

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
                                ModelConfig)

ARCHS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- dense -----------------------------------------------------------------
QWEN3_0_6B = _register(ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
))

QWEN2_5_32B = _register(ModelConfig(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120, grad_accum=4,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
))

DEEPSEEK_67B = _register(ModelConfig(
    name="deepseek-67b", family="dense", n_layers=95, d_model=8192, grad_accum=8,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016, vocab_size=102400,
    rope_theta=1e4,
))

GEMMA2_27B = _register(ModelConfig(
    name="gemma2-27b", family="dense", n_layers=46, d_model=4608, grad_accum=4,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=36864, vocab_size=256000,
    pattern=(ATTN_LOCAL, ATTN_GLOBAL), sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,  # query_pre_attn_scalar = d_model/n_heads
    post_norms=True, mlp_act="gelu", emb_scale=True, tie_embeddings=True,
    rope_theta=1e4,
))

# --- vlm ---------------------------------------------------------------
QWEN2_VL_2B = _register(ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
    qkv_bias=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
    vision_stub=True,
))

# --- ssm ---------------------------------------------------------------
RWKV6_1_6B = _register(ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, rwkv_head_dim=64,
    d_ff=7168, vocab_size=65536, pattern=(RWKV6,), scan_chunk=1024,
))

# --- hybrid ------------------------------------------------------------
RECURRENTGEMMA_9B = _register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096, grad_accum=2,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    pattern=(RGLRU, RGLRU, ATTN_LOCAL), sliding_window=2048, lru_width=4096,
    mlp_act="gelu", emb_scale=True, tie_embeddings=True, rope_theta=1e4,
))

# --- moe ---------------------------------------------------------------
MOONSHOT_16B_A3B = _register(ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048, grad_accum=2,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=163840,
    n_experts=64, top_k=6, moe_d_ff=1408, rope_theta=1e6,
))

MIXTRAL_8X22B = _register(ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144, grad_accum=4,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, moe_d_ff=16384,
    pattern=(ATTN_LOCAL,), sliding_window=4096, rope_theta=1e6,
))

# --- audio -------------------------------------------------------------
MUSICGEN_LARGE = _register(ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048, grad_accum=2,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab_size=2048,
    n_codebooks=4, rope_theta=1e4,
))


# ---------------------------------------------------------------------------
# Reduced smoke variants: same family/pattern/flags, tiny dims.
# ---------------------------------------------------------------------------
def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    pat = len(cfg.pattern)
    small = dict(
        n_layers=2 * pat + (1 if cfg.n_remainder_layers else 0),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        lru_width=64 if cfg.lru_width else 0,
        rwkv_head_dim=16,
        sliding_window=8 if cfg.sliding_window else None,
        attn_chunk=16,
        scan_chunk=32,
        query_scale=None if cfg.query_scale is None else 16.0 ** -0.5,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
        grad_accum=1,
    )
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=2, moe_d_ff=48)
    if cfg.n_codebooks:
        small.update(n_codebooks=2)
    return cfg.replace(name=cfg.name + "-smoke", **small)


SMOKE_ARCHS = {name: smoke_variant(cfg) for name, cfg in ARCHS.items()}
