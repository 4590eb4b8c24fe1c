"""Architecture + shape configuration dataclasses.

One ``ArchConfig`` describes a full architecture; each assigned arch file
(``src/repro/configs/<id>.py``) exports ``CONFIG`` (the exact published
hyperparameters) and ``SMOKE`` (a reduced same-family config for CPU smoke
tests). ``ShapeConfig`` describes one assigned input-shape cell.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | audio | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # --- attention options ---
    qkv_bias: bool = False          # qwen2.5
    rope_theta: float = 1e4
    sliding_window: int | None = None      # SWA window (danube, mixtral)
    local_window: int | None = None        # local-attn window for patterned archs
    local_global_ratio: int = 0            # gemma3: 5 local : 1 global
    logit_soft_cap: float | None = None

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0     # deepseek: layer 0 is dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 2048      # GShard grouped-dispatch group size

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- recurrent / ssm ---
    block_pattern: tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn")
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    lru_width: int | None = None

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_positions: int = 0      # precomputed frame embeddings (stub frontend)
    decoder_positions: int = 4096   # learned-pos table size (published whisper:
                                    # 448; enlarged so the assigned 32k cells
                                    # lower — deviation noted in DESIGN.md)

    # --- vlm (llama-3.2-vision) ---
    cross_attn_every: int = 0       # 1 cross-attn layer per this many layers
    num_image_tokens: int = 0       # precomputed patch embeddings (stub frontend)

    # --- norms / act / misc ---
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"               # silu | gelu (gated MLP except whisper)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    parallel_block: bool = False    # command-r: attn & mlp in parallel

    # --- training / execution ---
    dtype: str = "bfloat16"         # activation/compute dtype
    remat: bool = True
    remat_policy: str = "minimal"   # minimal (save nothing) | dots
    attention_impl: str = "blocked" # blocked (banded/q-chunked) | naive
    q_chunk: int = 512              # query chunk for global blocked attention
    scan_layers: bool = True
    microbatches: int = 1           # gradient-accumulation running sum (§4 of
                                    # DESIGN.md: the paper's Alg-3 trick applied
                                    # to grads)
    rules_override: dict | None = None   # per-arch logical-rule overrides

    @property
    def attention_kind(self) -> str:
        if self.use_mla:
            return "mla"
        return "gqa"

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
