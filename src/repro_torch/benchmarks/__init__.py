"""The paper's experiments on the port: ``table1_maxinput`` (Table 1, the
largest input trained under a fixed byte budget, with and without DTR) and
``fig4_overhead`` (Fig. 4 / App. D.3, metadata accesses and planner
milliseconds), on the card unless ``--device cpu``.

The counterparts of the repository's ``benchmarks/table1_maxinput.py`` and
``benchmarks/fig4_overhead.py``, run as
``python -m repro_torch.benchmarks.<name>``; ``benchmarks/run.py`` drives
the JAX package's.
"""
