"""Model configuration schema for all assigned architectures.

PyTorch port: a copy of :mod:`repro.configs.base`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"        # dense | ssm | moe | hybrid | audio | vlm
    source: str = ""             # provenance note from the assignment block

    # trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # activations / norms / embeddings
    hidden_act: str = "silu"     # silu (SwiGLU) | gelu (GeGLU) | relu2
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    scale_embeddings: bool = False     # gemma: embed * sqrt(d_model)
    logit_softcap: Optional[float] = None
    pos_embedding: str = "rope"        # rope | learned | none

    # attention pattern
    sliding_window: Optional[int] = None
    # pattern of one repeating group, e.g. 5 local : 1 global (gemma3)
    local_per_global: int = 0          # 0 = all-global
    # hybrid interleave (jamba): one attn layer per `attn_period` layers
    attn_period: int = 0               # 0 = all layers are attention
    attn_offset: int = 0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1                # MoE FFN every k-th layer
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0               # 0 -> ceil(d_model / 16)

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_positions: int = 0         # whisper: 1500 frames
    decoder_positions: int = 0         # whisper: learned decoder positions

    # modality frontend (STUB: input_specs supplies precomputed embeddings)
    frontend: Optional[str] = None     # audio | vision
    n_patches: int = 0                 # vlm: patch embeddings per image

    # numerics / execution
    n_microbatches: int = 1   # grad-accumulation microbatches per step
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: bool = True
    scan_layers: bool = True
    # optimizer memory policy (see repro.train.optimizer)
    optimizer_moments: str = "fp32"    # fp32 | bf16 | factored
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8

    # --------------------------------------------------------------- derived
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def group_len(self) -> int:
        """Repeating layer-pattern length (for scan-over-groups)."""
        import math
        g = 1
        if self.local_per_global:
            g = self.local_per_global + 1
        if self.attn_period:
            g = max(g, self.attn_period)
        if self.n_experts and self.moe_period > 1:
            g = g * self.moe_period // math.gcd(g, self.moe_period)
        return g

    def layer_kind(self, idx: int) -> Tuple[str, str]:
        """(mixer, ffn) kind of layer ``idx``.

        mixer ∈ {attn, attn_local, attn_global, mamba}
        ffn   ∈ {dense, moe, none}
        """
        if self.family == "ssm":
            return "mamba", "none"
        if self.attn_period:
            mixer = "attn" if idx % self.attn_period == self.attn_offset else "mamba"
        elif self.local_per_global:
            mixer = (
                "attn_global"
                if idx % (self.local_per_global + 1) == self.local_per_global
                else "attn_local"
            )
        else:
            mixer = "attn"
        if self.n_experts and idx % self.moe_period == self.moe_offset:
            ffn = "moe"
        else:
            ffn = "dense"
        return mixer, ffn

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.pos_embedding == "learned":
            total += (self.decoder_positions or 4096) * d
        for i in range(self.n_layers):
            mixer, ffn = self.layer_kind(i)
            if mixer.startswith("attn"):
                qkv = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
                total += qkv + self.n_heads * self.head_dim * d
            else:  # mamba
                di, n, r = self.d_inner, self.ssm_state, self.dt_rank
                total += d * 2 * di + di * self.ssm_conv + di * (r + 2 * n) + r * di + di * n + di + di * d
            if ffn == "dense":
                total += 3 * d * f
            elif ffn == "moe":
                total += d * self.n_experts + self.n_experts * 3 * d * f
            total += 2 * d  # norms
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                qkv = 4 * d * self.n_heads * self.head_dim
                total += qkv + 3 * d * f + 2 * d
            # cross-attention in decoder layers
            total += self.n_layers * 4 * d * self.n_heads * self.head_dim
            total += (self.encoder_positions + (self.decoder_positions or 448)) * d
        return total

    def n_active_params(self) -> int:
        """Active per-token parameters (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        total = self.n_params()
        for i in range(self.n_layers):
            _, ffn = self.layer_kind(i)
            if ffn == "moe":
                total -= (self.n_experts - self.experts_per_token) * 3 * d * f
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
