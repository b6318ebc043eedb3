#!/usr/bin/env python3
"""Host time a launch of the port's attention and convolution wrappers, for
one or more checkouts of the repository, on the card.

    python3 scripts/port_host_time.py [--kernels] [ROOT ...]

Each ROOT is a directory that holds ``rich_text_to_image_tpu_torch/`` (this
repository's root when none is given). To compare a change with its parent,
unpack the parent (``git archive``) into a git-ignored directory and name
both roots, each twice, in turns: the host is shared, so two readings of
the same tree differ by several microseconds, and only readings taken in
one run, side by side, can be compared. Every root is measured in a process
of its own (the packages share a name): the median of three times 300
launches with no synchronisation inside (``chip_smoke._host_us``) of
``flash_attention`` at [2,8,4096,40] and ``conv3x3`` at [2,64,64,320] -> 320.
With ``--kernels`` it also prints, for each root, the device time
(``chip_smoke._time_ms`` behind a busy card) of ``flash_attention`` at the
main paths' full-row shapes and of ``conv3x3`` at the 16 shapes of the
SD-1.5 UNet at B = 2 and 4: a change's kernels beside its parent's.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ATTN_SHAPES = [(b, 8, s, d) for s, d, bs in (
    (4096, 40, (2, 4, 6)), (1024, 80, (2, 4, 6)), (2304, 80, (2, 4)),
    (576, 160, (2, 4))) for b in bs]


def measure(root: str, kernels: bool) -> None:
    sys.path.insert(0, root)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV

    q, k, v = smoke._qkv(2, 8, 4096, 40, seed=2)
    x, w, bias = smoke._conv_inputs(2, 64, 64, 320, 320, seed=5)
    k1 = smoke._host_us(lambda: A.flash_attention(q, k, v, 40 ** -0.5))
    k5 = smoke._host_us(lambda: CV.conv3x3(x, w, bias))
    print(f"{root}: flash_attention {k1:.2f} us a launch, conv3x3 "
          f"{k5:.2f} us a launch ({smoke._smi()})", flush=True)
    if not kernels:
        return
    for b, h, s, d in ATTN_SHAPES:
        q, k, v = smoke._qkv(b, h, s, d, seed=s + d + b)
        ms = smoke._time_ms(lambda: A.flash_attention(q, k, v, d ** -0.5),
                            20, plug=True)
        print(f"{root}: flash_attention {[b, h, s, d]} {ms:.4f} ms",
              flush=True)
    for b in (2, 4):
        for r, c, o in smoke.SD15_CONV_SHAPES:
            x, w, bias = smoke._conv_inputs(b, r, r, c, o, seed=r + c + o + b)
            ms = smoke._time_ms(lambda: CV.conv3x3(x, w, bias), 20, plug=True)
            print(f"{root}: conv3x3 {[b, r, r, c]} -> {o} {ms:.4f} ms",
                  flush=True)


def main(argv) -> int:
    if argv[:1] == ["--measure"]:
        measure(argv[1], "--kernels" in argv[2:])
        return 0
    kernels = ["--kernels"] if "--kernels" in argv else []
    for root in [a for a in argv if a != "--kernels"] or [HERE]:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--measure", os.path.abspath(root), *kernels],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
