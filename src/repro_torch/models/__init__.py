"""The model substrate (counterpart of ``repro.models``): the dense
decoder family serves here (ROADMAP.md queue A items 13(a) and 13(b)).
"""

from repro_torch.models.model import build_model  # noqa: F401
