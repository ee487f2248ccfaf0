"""Measurement probes of the port, run as modules
(``python -m sml_tpu_torch.scripts.<name> [--device cuda]``): the
counterparts of the JAX package's eval-design probes in ``scripts/``."""
