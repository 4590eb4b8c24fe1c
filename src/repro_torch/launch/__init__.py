"""Entry points over the model substrate (counterpart of ``repro.launch``):
``inputs`` (batches) and ``serve`` (prefill, then a greedy decode loop)."""
