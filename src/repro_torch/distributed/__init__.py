"""Parameter declarations and their sharding metadata (counterpart of
``repro.distributed``).

On one card nothing is sharded: :func:`sharding.partition_spec` names the
mesh axes a tensor would take, as metadata, and placing tensors over a
device mesh (``named_shardings``, ``logical_sharding``) is ROADMAP.md
queue A item 13(d). ``pipeline_parallel`` runs the GPipe schedule over a
``StageMesh``, which may name one card once per stage.
"""

from repro_torch.distributed.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ParamSpec,
    abstract_params,
    init_params,
    logical_sharding,
    named_shardings,
    partition_spec,
    stack_spec,
)
