"""The port stands alone, and the parameter bridge covers the full models.

  * Importing every module of ``rich_text_to_image_tpu_torch`` loads no
    ``jax``/``flax``/``triton`` and no module of the JAX package, and needs
    none of the packages the GPU machine lacks (``regex``, Pillow, imageio,
    matplotlib, gradio, orbax, safetensors).
  * No source of the port (nor ``chip_smoke.py`` or the port's two
    colour-fixture scripts) imports them.
  * The kernels' CUDA sources are the files under ``csrc/`` and include
    only the CUDA toolkit's headers and each other; they build into the
    git-ignored ``_build/``.
  * At the full SD-1.5 shapes (JAX ``eval_shape`` only, no compute; torch
    modules on the meta device) every flax leaf maps to exactly one port
    parameter of the right shape, and every port parameter to one leaf.
"""

import ast
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models.clip import CLIPTextModel as JClip
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu.models.vae import AutoencoderKL as JVae
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel as TClip
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition as TUNet
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL as TVae
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rich_text_to_image_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "triton", "regex", "PIL",
           "imageio", "matplotlib", "gradio", "orbax", "safetensors")

_PROBE = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # importing it now raises ImportError
import rich_text_to_image_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print("MODULES", sorted(names))
bad = sorted(n for n, mod in sys.modules.items() if mod is not None and (
    n.split(".")[0] in {blocked!r} or n == "rich_text_to_image_tpu"
    or n.startswith("rich_text_to_image_tpu.")))
print("BAD", bad)
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _PROBE.format(blocked=BLOCKED)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    # the last modules of the JAX package, ported in the ninth slice
    for mod in ("parallel.mesh", "parallel.tp", "training.train_step",
                "native", "utils.flops"):
        assert f"'rich_text_to_image_tpu_torch.{mod}'" in res.stdout, mod


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "scripts", f"port_{name}_color_fixture.py")
        for name in ("train", "eval")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return (top in ("jax", "jaxlib", "flax", "optax")
            or top == "rich_text_to_image_tpu")


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _is_forbidden(n)]
    assert len(_sources()) > 20
    assert not bad, bad


def test_kernel_sources_are_in_the_repo_and_self_contained():
    from rich_text_to_image_tpu_torch.ops import build

    assert sorted(os.listdir(build.CSRC)) == sorted(
        build.SOURCES + build.HEADERS)
    assert {"attention.cu", "conv.cu"} <= set(build.SOURCES)
    toolkit = {"cuda_bf16.h", "cuda_runtime.h", "math.h", "stdint.h"}
    for name in build.SOURCES + build.HEADERS:
        with open(os.path.join(build.CSRC, name), encoding="utf-8") as f:
            included = set(re.findall(r'#include\s+[<"]([^>"]+)[>"]', f.read()))
        assert included <= toolkit | set(build.HEADERS), (name, included)
    # built at first use, beside the package, into a directory git ignores
    assert os.path.relpath(build.BUILD_DIR, ROOT) == os.path.join(
        "rich_text_to_image_tpu_torch", "_build")
    with open(os.path.join(ROOT, ".gitignore"), encoding="utf-8") as f:
        assert "rich_text_to_image_tpu_torch/_build/" in f.read().split()
    for src in build.SOURCES:  # a library per source, keyed by its content
        assert build._lib_path(src).startswith(build.BUILD_DIR + os.sep)


def test_kernel_mutants_apply_to_the_sources(tmp_path):
    """Each one-line mutant of ``scripts/port_kernel_mutants.sh`` still
    changes the source it names (the script itself runs on the card)."""
    with open(os.path.join(ROOT, "scripts", "port_kernel_mutants.sh"),
              encoding="utf-8") as f:
        script = f.read()
    block = script.split("mutants='", 1)[1].split("'\n", 1)[0]
    specs = [line.split("|", 2) for line in block.splitlines()]
    assert len(specs) >= 7
    for name, src, expr in specs:
        path = tmp_path / name
        with open(os.path.join(PKG, "csrc", src), encoding="utf-8") as f:
            path.write_text(f.read())
        subprocess.run(["sed", "-i", expr, str(path)], check=True)
        with open(os.path.join(PKG, "csrc", src), encoding="utf-8") as f:
            assert path.read_text() != f.read(), name


def _flax_shapes(module, *args):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize("which", ["unet", "vae", "text"])
def test_bridge_covers_full_sd15(which):
    if which == "unet":
        shapes = _flax_shapes(JUNet(C.SD15_UNET), jnp.zeros((1, 64, 64, 4)),
                              jnp.int32(0), jnp.zeros((1, 77, 768)))
        ctor = lambda: TUNet(C.SD15_UNET)
    elif which == "vae":
        shapes = _flax_shapes(JVae(C.SD15_VAE), jnp.zeros((1, 512, 512, 3)))
        ctor = lambda: TVae(C.SD15_VAE)
    else:
        shapes = _flax_shapes(JClip(C.SD15_TEXT), jnp.zeros((1, 77), jnp.int32))
        ctor = lambda: TClip(C.SD15_TEXT)
    with torch.device("meta"):
        module = ctor()
    mapped = weights.map_flax_tree(shapes, which)
    weights.check_coverage(mapped, module)  # raises on any gap either way
    assert len(mapped) == len(module.state_dict())


def test_bridge_fails_on_leftover_or_missing_leaf():
    params = jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        _flax_shapes(JClip(C.TINY_TEXT), jnp.zeros((1, 77), jnp.int32)))
    module = TClip(C.TINY_TEXT)
    weights.load_flax(module, params, "text")
    extra = {"params": dict(params["params"], stray={"kernel": np.zeros(2)})}
    with pytest.raises(KeyError):
        weights.from_flax(extra, "text", module)
    fewer = {"params": {k: v for k, v in params["params"].items()
                        if k != "final_layer_norm"}}
    with pytest.raises(KeyError):
        weights.from_flax(fewer, "text", module)
