"""qwen2.5-32b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-32B; hf]

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.

§Arch-applicability: token-LM — the paper's denoise stage applies at the
framework level (streaming ingest + running-sum grad accumulation), not
inside the layers. long_500k skipped: pure full attention (DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    microbatches=16,
    # §Perf HC1: 40 heads don't divide 16-way TP -> sequence-parallel
    # attention queries (exact; see EXPERIMENTS.md)
    rules_override={"act_attn_q_seq": "model"},
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = False  # pure full attention
