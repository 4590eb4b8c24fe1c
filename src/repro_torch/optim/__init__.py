"""Optimizer and gradient compression (counterpart of ``repro.optim``).

``AdamW``, ``cosine_schedule`` and ``global_norm`` (``optim/adamw.py``)
drive the model substrate's training step (``repro_torch.launch.steps``);
``repro_torch.optim.compress`` holds the int8 and top-k error-feedback
compressors that the trainer's ``--compress`` and the compressed egress
(``repro_torch.core.egress``) send through.
"""

from repro_torch.optim import compress  # noqa: F401
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm  # noqa: F401
