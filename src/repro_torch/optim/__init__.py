"""Compression primitives (counterpart of ``repro.optim``).

``repro_torch.optim.compress`` holds the int8 and top-k compressors that
the compressed egress (``repro_torch.core.egress``) sends partials
through. The reference's ``AdamW``/``cosine_schedule`` belong to the model
substrate (ROADMAP.md queue A item 13).
"""
