"""command-r-35b [dense] — GQA, no-bias, parallel residual block, tied
embeddings, layernorm. [hf:CohereForAI/c4ai-command-r-v01; unverified]

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.

long_500k skipped: pure full attention.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=8e6,
    norm_type="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    microbatches=16,
)

SMOKE = ArchConfig(
    name="command-r-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    norm_type="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = False
