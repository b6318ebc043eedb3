"""The kernel wrappers refuse autograd off the CPU.

The CUDA kernels have no backward pass, so a wrapper that launched one for
an input requiring a gradient would return an output cut off from the
graph, and a caller differentiating through it would get a zero gradient
without an error. Every wrapper raises there instead, before it launches
or builds anything; the ``meta`` device stands in for the card here (any
device but the CPU takes the kernel's branch). On the CPU the wrappers run
their plain versions, which autograd differentiates, as the JAX package's
XLA path is (the JAX package's Pallas kernels raise under ``jax.grad``).
"""

import pytest
import torch

from rich_text_to_image_tpu_torch.models import unet as T
from rich_text_to_image_tpu_torch.ops import attention as A
from rich_text_to_image_tpu_torch.ops import conv as CV
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


def _inputs(device, grad):
    bf = torch.bfloat16 if device != "cpu" else torch.float32
    q, k, v = (torch.randn((1, 2, 520, 40), dtype=bf, device=device)
               .requires_grad_(grad) for _ in range(3))
    lse = torch.zeros((1, 2, 520), device=device)
    x = torch.randn((1, 8, 8, 64), dtype=bf, device=device).requires_grad_(
        grad)
    w = torch.randn((3, 3, 64, 64), dtype=bf, device=device)
    b = torch.randn((64,), dtype=bf, device=device)
    return {
        "flash_attention": lambda: A.flash_attention(q, k, v),
        "flash_attention_avg_probs":
            lambda: A.flash_attention_avg_probs(q, k, v),
        "flash_attention_lse": lambda: A.flash_attention_lse(q, k, v),
        "avg_probs_from_lse": lambda: A.avg_probs_from_lse(q, k, lse),
        "conv3x3": lambda: CV.conv3x3(x, w, b),
    }, (q, x)


WRAPPERS = ["flash_attention", "flash_attention_avg_probs",
            "flash_attention_lse", "avg_probs_from_lse", "conv3x3"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_under_autograd_off_the_cpu(name):
    calls, _ = _inputs("meta", True)
    A.reset_launches()
    CV.reset_launches()
    with pytest.raises(RuntimeError, match=f"^{name}: .*no backward"):
        calls[name]()
    assert not any(A.LAUNCHES.values()) and not CV.LAUNCHES["conv3x3"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_takes_the_kernel_branch_under_no_grad(name):
    """With grad mode off the guard lets the call through to the kernel's
    branch, which here fails only for want of the CUDA toolkit."""
    calls, _ = _inputs("meta", True)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
        calls[name]()


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_plain_versions_are_differentiable(name):
    calls, (q, x) = _inputs("cpu", True)
    out = calls[name]()
    loss = sum(o.float().square().sum() for o in (
        out if isinstance(out, tuple) else (out,)))
    loss.backward()
    leaf = x if name == "conv3x3" else q
    assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0


def test_conv_module_raises_with_the_gate_on_and_a_weight_needing_grad():
    """``Conv3x3`` hands the kernel a detached repack of its weight, so it
    checks its own parameters before the wrapper does."""
    conv = T.Conv3x3(64, 64).to(device="meta", dtype=torch.bfloat16)
    x = torch.empty((1, 64, 8, 8), device="meta", dtype=torch.bfloat16)
    CV.enable_kernel_conv(True)
    try:
        with pytest.raises(RuntimeError, match="no backward"):
            conv(x)
    finally:
        CV.enable_kernel_conv(False)


@pytest.mark.cuda
def test_wrappers_raise_under_autograd_on_card():
    """On the card: each wrapper raises and launches nothing
    (chip_smoke.py's ``grad-guard:`` line runs the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check")
    calls, _ = _inputs("cuda", True)
    A.reset_launches()
    for name, fn in calls.items():
        with pytest.raises(RuntimeError, match=f"^{name}: "):
            fn()
    assert not any(A.LAUNCHES.values())
