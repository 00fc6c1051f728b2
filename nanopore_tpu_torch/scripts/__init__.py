"""Post-hoc scripts (copies of the JAX package's ``scripts/``); each
runs as ``python -m nanopore_tpu_torch.scripts.<name>``."""
