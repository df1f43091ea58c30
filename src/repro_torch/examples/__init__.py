"""The JAX package's five examples (``examples/``), on the port: each runs
with ``python -m repro_torch.examples.<name>``, on the card unless
``--device cpu`` is given."""
