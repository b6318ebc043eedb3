"""The plain reference: plain PyTorch and NumPy, importing nothing of the
program. ``check.py`` holds the comparison that decides ``correct``."""
