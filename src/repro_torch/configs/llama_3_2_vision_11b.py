"""llama-3.2-vision-11b [vlm] — text backbone with tanh-gated
cross-attention image layers every 5th position; the vision tower is a
STUB per the assignment (input_specs provides precomputed patch
embeddings). [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; 8 cross layers.

This and whisper are the natural consumers of the paper's denoise stage:
PRISM frames -> StreamingDenoiser -> patch/frame embeddings (DESIGN.md §4).

long_500k skipped: pure full attention.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1601,
    rope_theta=5e5,
    microbatches=16,
)

SMOKE = ArchConfig(
    name="llama-vision-smoke",
    family="vlm",
    num_layers=10,           # 2 pattern groups
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=5,
    num_image_tokens=16,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = False
