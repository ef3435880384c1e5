"""The examples a user runs first, on the card unless ``--device cpu``:
``quickstart`` (the simulator, the eager executor, a DTR train step),
``train_lm`` (the training driver with checkpoints and monitors) and
``dynamic_treelstm`` (the paper's dynamic model under a byte budget).

The counterparts of the repository's ``examples/``, run as
``python -m repro_torch.examples.<name>``.
"""
