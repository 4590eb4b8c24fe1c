"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

Sharding note: 8 experts < 16-way model axis, so experts are replicated
and each expert's d_ff is tensor-parallel instead (rules_override) — the
few-large-experts regime (DESIGN.md §5).

long_500k RUNS: SWA (4096) bounds the KV working set.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    sliding_window=4096,
    rope_theta=1e6,
    microbatches=8,
    # §Perf HC2: few-large-experts regime — experts replicated, expert
    # d_ff tensor-parallel; ACTIVATION axes must follow (it1) and the MoE
    # group dim pins to `data` (it2, now a framework default).
    rules_override={"experts": None, "expert_mlp": "model",
                    "act_experts": None, "act_expert_mlp": "model"},
)

SMOKE = ArchConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=2,
    moe_d_ff=128,
    sliding_window=8,
    dtype="float32",
    remat=False,
)

LONG_CONTEXT_OK = True
