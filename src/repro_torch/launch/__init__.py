"""Entry points over the model substrate (counterpart of ``repro.launch``):
``inputs`` (batches), ``mesh`` (the one-card mesh and the card's peak
rates), ``steps`` (train, prefill and decode steps), ``train`` (the
training driver) and ``serve`` (prefill, then a greedy decode loop)."""
