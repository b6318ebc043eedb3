"""Weights for the port: the bridge from the JAX package's parameter trees,
a random init, and a safetensors reader and writer (local diffusers
directories, and the port's checkpoints, ``models/checkpoint.py``).

The port's modules carry diffusers' parameter names, so a diffusers state
dict loads into them as it is. The JAX package names its flax leaves
differently (``down_blocks_0/resnets_1/conv1/kernel``); the rules below map
each flax path to the diffusers name, as the JAX package's converter
(``models/convert.py``) does in the other direction, and transform the leaf:
HWIO conv kernels to OIHW, Dense ``[in, out]`` kernels to Linear
``[out, in]``, ``scale`` to ``weight``. The bridge fails on any leaf it cannot
map and on any module parameter that no leaf filled.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Mapping

import numpy as np
import torch
from torch import nn

_SUFFIX = {"kernel": "weight", "bias": "bias", "scale": "weight",
           "embedding": "weight"}


# -------------------------------------------------------------------- rules
def _unet_rule(path: tuple[str, ...]) -> str:
    def tr(p: str) -> str:
        p = re.sub(r"^(down_blocks|up_blocks)_(\d+)$", r"\1.\2", p)
        return re.sub(r"^(resnets|attentions|transformers|transformer_blocks)"
                      r"_(\d+)$",
                      r"\1.\2", p)

    name = ".".join(tr(p) for p in path[:-1])
    name = name.replace(".downsample", ".downsamplers.0.conv")
    name = name.replace(".upsample", ".upsamplers.0.conv")
    name = name.replace(".to_out", ".to_out.0")
    name = name.replace(".ff.geglu", ".ff.net.0.proj")
    name = name.replace(".ff.out", ".ff.net.2")
    return f"{name}.{_SUFFIX[path[-1]]}"


def _vae_rule(path: tuple[str, ...]) -> str:
    name = ".".join(path[:-1])
    name = re.sub(r"down_(\d+)_res_(\d+)", r"down_blocks.\1.resnets.\2", name)
    name = re.sub(r"down_(\d+)_downsample",
                  r"down_blocks.\1.downsamplers.0.conv", name)
    name = re.sub(r"up_(\d+)_res_(\d+)", r"up_blocks.\1.resnets.\2", name)
    name = re.sub(r"up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0.conv",
                  name)
    name = re.sub(r"mid_res_(\d+)", r"mid_block.resnets.\1", name)
    name = name.replace("mid_attn", "mid_block.attentions.0")
    name = re.sub(r"(mid_block\.attentions\.0)\.to_out$", r"\1.to_out.0", name)
    return f"{name}.{_SUFFIX[path[-1]]}"


def _text_rule(path: tuple[str, ...]) -> str:
    if path[-1] == "position_embedding":  # a bare param in the flax tree
        return "text_model.embeddings.position_embedding.weight"
    name = ".".join(path[:-1])
    if name == "token_embedding":
        return "text_model.embeddings.token_embedding.weight"
    if name == "text_projection":  # beside text_model (WithProjection)
        return "text_projection.weight"
    name = re.sub(r"layers_(\d+)\.(self_attn|layer_norm)",
                  r"encoder.layers.\1.\2", name)
    name = re.sub(r"layers_(\d+)\.fc(\d)", r"encoder.layers.\1.mlp.fc\2", name)
    return f"text_model.{name}.{_SUFFIX[path[-1]]}"


def _clip_vision_rule(path: tuple[str, ...]) -> str:
    # the class and position embeddings are bare params in the flax tree
    if path[-1] == "class_embedding":
        return "vision_model.embeddings.class_embedding"
    if path[-1] == "position_embedding":
        return "vision_model.embeddings.position_embedding.weight"
    name = ".".join(path[:-1])
    if name == "patch_embedding":
        return "vision_model.embeddings.patch_embedding.weight"
    if name == "visual_projection":  # beside vision_model, as in HF
        return "visual_projection.weight"
    name = re.sub(r"layers_(\d+)\.(self_attn|layer_norm)",
                  r"encoder.layers.\1.\2", name)
    name = re.sub(r"layers_(\d+)\.fc(\d)", r"encoder.layers.\1.mlp.fc\2", name)
    return f"vision_model.{name}.{_SUFFIX[path[-1]]}"


RULES = {"unet": _unet_rule, "vae": _vae_rule, "text": _text_rule,
         "clip_vision": _clip_vision_rule}


def _flatten(tree: Mapping, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _to_torch_axes(path: tuple[str, ...], ndim: int) -> tuple[int, ...]:
    """The permutation taking a flax leaf to the port's layout."""
    if path[-1] == "kernel" and ndim == 4:
        return (3, 2, 0, 1)  # HWIO -> OIHW
    if path[-1] == "kernel" and ndim == 2:
        return (1, 0)  # Dense [in, out] -> Linear [out, in]
    return tuple(range(ndim))


def map_flax_tree(params: Mapping, which: str) -> dict[str, tuple]:
    """{torch name: (flax path, leaf)} for every leaf of a flax param tree
    (with or without the top-level ``params`` key). Raises on a leaf that
    maps to a name already taken."""
    if set(params) == {"params"}:
        params = params["params"]
    rule = RULES[which]
    out: dict[str, tuple] = {}
    for path, leaf in _flatten(params).items():
        name = rule(path)
        if name in out:
            raise ValueError(f"bridge: {path} and {out[name][0]} both map to "
                             f"{name}")
        out[name] = (path, leaf)
    return out


def torch_shape(path: tuple[str, ...], shape) -> tuple[int, ...]:
    """The shape a flax leaf takes in the port's layout."""
    return tuple(shape[i] for i in _to_torch_axes(path, len(shape)))


def check_coverage(mapped: Mapping[str, tuple], module: nn.Module) -> None:
    """Every mapped leaf names a module parameter of its shape, and every
    module parameter is filled by exactly one leaf."""
    want = {n: tuple(p.shape) for n, p in module.state_dict().items()}
    extra = sorted(set(mapped) - set(want))
    missing = sorted(set(want) - set(mapped))
    if extra or missing:
        raise KeyError(f"bridge: {len(extra)} flax leaves map to no parameter "
                       f"{extra[:5]}; {len(missing)} parameters have no leaf "
                       f"{missing[:5]}")
    for name, (path, leaf) in mapped.items():
        got = torch_shape(path, np.shape(leaf))
        if got != want[name]:
            raise ValueError(f"bridge: {path} -> {name} has shape {got}, the "
                             f"parameter {want[name]}")


def from_flax(params: Mapping, which: str,
              module: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """The JAX package's ``which`` ("unet", "vae", "text" or
    "clip_vision") parameter tree,
    nested dicts of numpy arrays, as the port's float32 state dict. With
    ``module``, also checks that the tree covers its parameters exactly."""
    mapped = map_flax_tree(params, which)
    if module is not None:
        check_coverage(mapped, module)
    out = {}
    for name, (path, leaf) in mapped.items():
        arr = np.asarray(leaf).astype(np.float32)  # bf16 leaves upcast here
        arr = arr.transpose(_to_torch_axes(path, arr.ndim))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax(module: nn.Module, params: Mapping, which: str) -> nn.Module:
    """Load a JAX parameter tree into ``module`` (strict both ways)."""
    module.load_state_dict(from_flax(params, which, module), strict=True)
    return module


# the rules' renames undone, on a diffusers name without its suffix
_UNET_BACK = ((".downsamplers.0.conv", ".downsample"),
              (".upsamplers.0.conv", ".upsample"), (".to_out.0", ".to_out"),
              (".ff.net.0.proj", ".ff.geglu"), (".ff.net.2", ".ff.out"))
_VAE_BACK = ((r"down_blocks\.(\d+)\.resnets\.(\d+)", r"down_\1_res_\2"),
             (r"down_blocks\.(\d+)\.downsamplers\.0\.conv",
              r"down_\1_downsample"),
             (r"up_blocks\.(\d+)\.resnets\.(\d+)", r"up_\1_res_\2"),
             (r"up_blocks\.(\d+)\.upsamplers\.0\.conv", r"up_\1_upsample"),
             (r"mid_block\.resnets\.(\d+)", r"mid_res_\1"),
             (r"mid_block\.attentions\.0\.to_out\.0", "mid_attn.to_out"),
             (r"mid_block\.attentions\.0", "mid_attn"))


def _flax_path(name: str, which: str) -> tuple[str, ...]:
    """The flax path (without its leaf) of a diffusers module name."""
    if which == "unet":
        for new, old in _UNET_BACK:
            name = name.replace(new, old)
        name = re.sub(r"(^|\.)(down_blocks|up_blocks|resnets|attentions|"
                      r"transformers|transformer_blocks)\.(\d+)(?=\.|$)",
                      r"\1\2_\3", name)
    elif which == "vae":
        for pat, rep in _VAE_BACK:
            name = re.sub(pat, rep, name)
    else:
        raise ValueError(f"to_flax: no rule back for {which!r}")
    return tuple(name.split("."))


def to_flax(module: nn.Module, which: str) -> dict:
    """The inverse of :func:`from_flax` for ``which`` "unet" or "vae":
    ``module``'s parameters as the JAX package's tree ``{"params": ...}`` of
    float32 numpy arrays (flax paths, HWIO conv kernels, Dense ``[in,
    out]`` kernels, ``scale`` for a norm's weight). Each path is checked to
    map back to its parameter's name."""
    rule, tree = RULES[which], {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                leaf = "bias"
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                leaf = "scale"
            elif isinstance(mod, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "kernel"
            path = _flax_path(mname, which) + (leaf,)
            name = f"{mname}.{pname}"
            if rule(path) != name:
                raise ValueError(f"to_flax: {name} -> {path} maps back to "
                                 f"{rule(path)}")
            arr = p.detach().float().cpu().numpy()
            perm = np.argsort(_to_torch_axes(path, arr.ndim))
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(arr.transpose(perm))
    return {"params": tree}


# ------------------------------------------------------------- random init
@torch.no_grad()
def random_init(module: nn.Module, seed: int) -> nn.Module:
    """Fill ``module``'s parameters with numpy fan-in-scaled normals, as the
    JAX package's ``models/init_utils.fast_init`` does: ones for norm
    weights, zeros for biases, N(0, 1/fan_in) elsewhere, fan_in counted as
    in the flax layout (all but the output dim; the row count for an
    embedding table). Statistically sane, not checkpoint-compatible, and not
    the JAX package's numbers for the same seed."""
    rng = np.random.default_rng(seed)
    norms = (nn.LayerNorm, nn.GroupNorm)
    for mod in module.modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, norms):
                p.fill_(1.0)
            else:
                fan_in = (p.shape[0] if isinstance(mod, nn.Embedding)
                          else int(np.prod(p.shape[1:])))
                arr = rng.standard_normal(tuple(p.shape), dtype=np.float32)
                arr *= np.float32(1.0 / np.sqrt(max(fan_in, 1)))
                p.copy_(torch.from_numpy(arr))
    return module


@torch.no_grad()
def random_init_device(module: nn.Module, seed: int) -> nn.Module:
    """The rule of :func:`random_init` drawn where the parameters lie, from
    a seeded ``torch.Generator`` of their device, and stored in their dtype:
    for a model too large to draw on the host (SDXL's ~3.5 billion
    parameters). Build the module on the meta device and ``to_empty`` it
    onto the card first. Not :func:`random_init`'s numbers for the seed."""
    gen = {}
    norms = (nn.LayerNorm, nn.GroupNorm)
    for mod in module.modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "bias":
                p.zero_()
            elif isinstance(mod, norms):
                p.fill_(1.0)
            else:
                if p.device not in gen:
                    gen[p.device] = torch.Generator(
                        device=p.device).manual_seed(seed)
                fan_in = (p.shape[0] if isinstance(mod, nn.Embedding)
                          else int(np.prod(p.shape[1:])))
                x = torch.randn(tuple(p.shape), generator=gen[p.device],
                                device=p.device, dtype=torch.float32)
                p.copy_(x.mul_(1.0 / np.sqrt(max(fan_in, 1))))
    return module


# -------------------------------------------------------------- safetensors
# safetensors dtype names; a stdlib + torch reader and writer of the format:
# an 8-byte little-endian header length, a JSON header of {name: {dtype,
# shape, data_offsets}}, then the raw little-endian tensors
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """One ``.safetensors`` file as CPU tensors in their stored dtypes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        a, b = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        if b > a:  # a copy of its own: aligned, writable, freed with it
            t = torch.frombuffer(bytearray(data[a:b]), dtype=dtype)
        else:
            t = torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` (any device) as one ``.safetensors`` file in their
    own dtypes, through a temporary file renamed into place; returns the
    bytes written. No pickle is involved."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.nbytes]}
        blobs.append(raw)
        offset += raw.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw.data)
    os.replace(tmp, path)
    return 8 + len(head) + offset


def load_safetensors_dir(path: str) -> dict[str, torch.Tensor]:
    """Every ``*.safetensors`` file under ``path`` as one float32 state
    dict."""
    sd: dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".safetensors"):
            sd.update((k, v.float()) for k, v in
                      read_safetensors(os.path.join(path, fn)).items())
    if not sd:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return sd
