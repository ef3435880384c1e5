"""The benchmark of the PyTorch / H100 port (``repro_torch``): training
steps under the port's remat policies, driven by data files.  See
``run.py``."""
