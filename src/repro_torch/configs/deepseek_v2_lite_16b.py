"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE:
2 shared + 64 routed experts, top-6, first layer dense.
[arXiv:2405.04434; hf]

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400.
(The assignment block lists both "64e" and "160 routed"; the published
V2-Lite config is 64 routed + 2 shared, which we use. Dense first layer
uses the published d_ff=10944.)

long_500k skipped: full attention (MLA compresses the cache but attention
is still quadratic over 500k prefill and O(S) full-cache decode; the
assignment's sub-quadratic criterion excludes it).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,               # dense first layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    moe_group_size=512,   # fine-grained experts: keep dispatch << expert flops
    rope_theta=1e4,
    microbatches=8,
)

SMOKE = ArchConfig(
    name="deepseek-v2-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    use_mla=True,
    kv_lora_rank=32,
    qk_rope_dim=8,
    qk_nope_dim=16,
    v_head_dim=16,
    num_experts=8,
    num_experts_per_tok=2,
    num_shared_experts=1,
    moe_d_ff=32,
    first_dense_layers=1,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = False
