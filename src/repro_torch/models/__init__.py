"""The model substrate (counterpart of ``repro.models``): every family
serves here, on the CPU and the card (ROADMAP.md queue A items 13(a) and
13(b)); training is item 13(c).
"""

from repro_torch.models.model import build_model  # noqa: F401
