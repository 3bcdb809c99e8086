"""Architecture configuration schema for the model zoo.

One frozen dataclass describes every assigned architecture; family-specific
fields are zero/None when unused.  ``reduced()`` produces the small smoke-test
variant of the same family (assignment: smoke tests instantiate a reduced
config; full configs are exercised only via the dry-run).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int         # query heads; 0 for attention-free (ssm)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0      # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dispatch: str = "auto"   # auto | tp_local | ep_a2a (condensed)
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    residual_d_ff: int = 0

    # --- attention flavor ---
    qkv_bias: bool = False        # qwen2.5
    swa_window: int = 0           # 0 = full attention; mixtral/hymba use SWA
    rope_theta: float = 1e4

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0          # 0 -> d_model // 16

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0          # precomputed frame count (frontend stub)

    # --- VLM ---
    cross_attn_period: int = 0    # every k-th layer cross-attends to images
    num_image_tokens: int = 0     # precomputed patch embeds (frontend stub)

    act: str = "swiglu"           # swiglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # --- embedding gather strategy (the paper's ladder; DESIGN.md §4) ---
    embed_gather: str = "onehot_psum"   # replicate | onehot_psum

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_state and not self.ssm_dt_rank:
            object.__setattr__(self, "ssm_dt_rank", max(1, self.d_model // 16))

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def is_vlm(self) -> bool:
        return self.family == "vlm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode: SSM state or bounded SWA window."""
        return self.ssm_state > 0 or self.swa_window > 0

    def param_count(self) -> tuple[int, int]:
        """(total_params, active_params). Analytic; cross-checked against
        eval_shape in tests."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_attn = 0
        if self.num_heads:
            n_attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            if self.qkv_bias:
                n_attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        n_mlp_dense = (3 if self.act == "swiglu" else 2) * d * f
        n_ssm = 0
        if self.ssm_state:
            di, st, dr = self.d_inner, self.ssm_state, self.ssm_dt_rank
            n_ssm = (d * 2 * di + di * self.ssm_conv + di
                     + di * (dr + 2 * st) + dr * di + di
                     + di * st + di + di * d)
        n_norms = 2 * d

        per_layer_total = n_norms
        per_layer_active = n_norms
        if self.is_moe:
            n_expert = (3 if self.act == "swiglu" else 2) * d * f
            n_router = d * self.num_experts
            per_layer_total += n_attn + n_router + self.num_experts * n_expert
            per_layer_active += n_attn + n_router \
                + self.experts_per_token * n_expert
            if self.dense_residual:
                rff = (3 if self.act == "swiglu" else 2) * d * self.residual_d_ff
                per_layer_total += rff
                per_layer_active += rff
        elif self.is_ssm_only:
            per_layer_total += n_ssm
            per_layer_active += n_ssm
        elif self.is_hybrid:
            per_layer_total += n_attn + n_ssm + n_mlp_dense
            per_layer_active += n_attn + n_ssm + n_mlp_dense
        else:
            per_layer_total += n_attn + n_mlp_dense
            per_layer_active += n_attn + n_mlp_dense

        total = self.num_layers * per_layer_total
        active = self.num_layers * per_layer_active

        # VLM: every period-th layer is a cross-attn block with the same
        # parameter volume as a dense block (attn shapes match) — no extra.

        if self.is_encdec:
            enc_layer = n_attn + n_mlp_dense + n_norms
            total += self.encoder_layers * enc_layer
            active += self.encoder_layers * enc_layer
            # decoder cross-attn per layer
            total += self.num_layers * (n_attn + d)
            active += self.num_layers * (n_attn + d)

        emb = v * d * (1 if self.tie_embeddings else 2)
        total += emb + d  # final norm
        active += emb + d
        return int(total), int(active)

    def flops_param_count(self) -> int:
        """Active params excluding the embedding table (gather, ~0 flops);
        the head matmul is charged separately by callers that compute full
        logits.  This is the N in MODEL_FLOPS = 6·N·tokens."""
        _, active = self.param_count()
        return int(active - self.vocab_size * self.d_model
                   * (1 if self.tie_embeddings else 2))
