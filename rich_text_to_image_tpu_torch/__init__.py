"""rich_text_to_image_tpu_torch — the PyTorch/CUDA port of
``rich_text_to_image_tpu``.

A second package beside the JAX one, with the same layout (``models/``,
``ops/``, ``pipelines/``, ``schedulers/``, ``utils/``, ``cli/``). It imports
torch and numpy and nothing of JAX or of the JAX package. The self-attention
kernels that the JAX package writes in Pallas for the TPU are CUDA C++ for
Hopper here (``csrc/``), built with ``nvcc`` at first use; on CPU tensors
their wrappers run the plain PyTorch versions instead.

Entry points take a ``device`` that defaults to ``"cuda"``; the tests pass
``device="cpu"``.
"""

__version__ = "0.1.0"
