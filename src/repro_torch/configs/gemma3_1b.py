"""gemma3-1b [dense] — 5:1 local:global attention, MQA (kv=1), 128k
context, huge vocab, tied embeddings. [hf:google/gemma-3-1b-pt; unverified]

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
Pattern-scanned as 4 groups of [5×local(512), global] + 2 local remainder.

long_500k RUNS: local layers use ring caches; the few global layers'
caches are sequence-sharded over the mesh ``data`` axis (context
parallelism) — see DESIGN.md §4.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    local_global_ratio=5,
    local_window=512,
    rope_theta=1e6,
    tie_embeddings=True,
    microbatches=4,
    # 4 heads don't divide 16-way TP -> sequence-parallel attention
    rules_override={"act_attn_q_seq": "model"},
)

SMOKE = ArchConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=12,          # 2 pattern groups
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    local_global_ratio=5,
    local_window=8,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = True
