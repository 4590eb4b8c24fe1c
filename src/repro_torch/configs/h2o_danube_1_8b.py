"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window
attention. [arXiv:2401.16818; hf]

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.

long_500k RUNS: SWA bounds the KV working set (ring cache, O(window)).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
    microbatches=4,
)

SMOKE = ArchConfig(
    name="h2o-danube-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    sliding_window=8,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = True
