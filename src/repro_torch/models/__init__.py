"""The model substrate (counterpart of ``repro.models``): every family
serves and trains here, on the CPU and the card (ROADMAP.md queue A items
13(a)-13(c); the training step is ``repro_torch.launch.steps``).
"""

from repro_torch.models.model import build_model  # noqa: F401
