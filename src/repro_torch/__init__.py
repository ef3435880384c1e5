"""PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

Mirrors the JAX package's layout (``repro_torch/models/layers.py`` is the
counterpart of ``repro/models/layers.py``) and imports nothing of it: what
it needs of the plain-Python modules it keeps as its own copies, which the
tests hold to the originals.
"""
