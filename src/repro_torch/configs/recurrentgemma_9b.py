"""recurrentgemma-9b [hybrid] — Griffin: RG-LRU recurrent blocks + local
attention, 2:1 pattern (2 recurrent then 1 local-attn).
[arXiv:2402.19427; unverified]

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Pattern-scanned as 12 groups of [rec, rec, attn-local(2048)] + 2 rec.

long_500k RUNS: RG-LRU state is O(width); attention layers use ring caches.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    act="gelu",
    tie_embeddings=True,
    rope_theta=1e4,
    microbatches=8,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=6,            # 2 pattern groups
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    block_pattern=("rec", "rec", "attn"),
    local_window=8,
    lru_width=64,
    conv_width=4,
    act="gelu",
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = True
