"""PyTorch/CUDA port of the real-compute disaggregated serving path.

Imports ``torch`` and nothing from the JAX package ``repro``: what it needs
from ``repro``'s pure-Python modules it keeps as its own copies.
"""
