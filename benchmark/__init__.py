"""The benchmark of the PyTorch/CUDA port: ``run.py`` runs one cell once;
see ``harness.py`` for a run and ``reference/`` for the plain reference
that decides ``correct``."""
