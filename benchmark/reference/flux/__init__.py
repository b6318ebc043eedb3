"""The plain reference of the ``flux`` family (FLUX.1-dev): its networks
(``nets.py``) and the comparison's stages (``check.py``), plain PyTorch in
float32 with TF32 off."""
