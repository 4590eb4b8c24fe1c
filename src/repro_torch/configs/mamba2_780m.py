"""mamba2-780m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]

48L d_model=1536 vocab=50280, ssm_state=128, expand=2, headdim=64
(-> 48 SSD heads), depthwise conv width 4, no MLP (d_ff=0).

long_500k RUNS: constant-size SSM state — the flagship sub-quadratic cell.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=48,            # d_inner / ssm_head_dim
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
    microbatches=8,
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=0,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    ssm_state_dim=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=8,
    ssm_groups=1,
    conv_width=4,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = True
