"""Device mesh and sharding rules, on ``torch.distributed``.

Counterpart of ``rich_text_to_image_tpu/parallel/mesh.py``. The reference
is single-GPU; the JAX package introduced the parallelism, and the port keeps
its axes and its ``--mesh`` grammar:

  * ``dp`` — data parallelism: the UNet's batched rows (CFG rows, region
    rows, benchmark items) split over the ranks, each rank running its
    contiguous block (``pipelines/base.py``);
  * ``tp`` — tensor parallelism: a weight's output channels split over the
    ranks, each layer's output gathered right after it, and attention run
    on each rank's own heads (``parallel/tp.py``);
  * ``dcn`` — an outermost data axis: parameters never shard on it, only the
    batch crosses it.

One process per device, as ``torchrun`` starts them. Where GSPMD places a
program over all devices from one process, here every rank runs the same
Python and the collectives are explicit. Ranks lie on the mesh in row-major
order of its axes (the JAX package's ``create_device_mesh`` on a contiguous
device list).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# What :func:`all_gather_cat` moved since the last :func:`reset_gathers`:
# its calls and the elements of the tensors it returned (every rank's block
# together), for the tests and the smoke run to read.
GATHERS = {"calls": 0, "elements": 0}


def reset_gathers() -> None:
    GATHERS.update(calls=0, elements=0)


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: ``shape`` {axis: size}, outermost axis
    first (``{"dp": 2, "tp": 4}``, ``{"dcn": 2, "dp": 2, "tp": 2}``), its
    ``coords`` on each axis, the process ``groups`` of its dp and tp axes and
    ``"batch"``, the ranks it shares its tp coordinate with (the (dcn, dp)
    axes together: those over which rows split), and the ``DeviceMesh``."""

    shape: dict
    coords: dict
    groups: dict
    device_mesh: object = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def batch_size(self) -> int:
        return int(np.prod([n for a, n in self.shape.items() if a != "tp"]))

    @property
    def batch_rank(self) -> int:
        names = [a for a in self.shape if a != "tp"]
        return int(np.ravel_multi_index([self.coords[a] for a in names],
                                        [self.shape[a] for a in names]))

    def row_counts(self, n: int) -> list:
        """Rows of a batch of ``n`` that each batch rank runs: contiguous
        blocks, the first ``n % ranks`` one row longer (rows need not
        divide)."""
        k = self.batch_size
        return [n // k + (1 if i < n % k else 0) for i in range(k)]

    def rows(self, n: int) -> tuple:
        """(lo, hi): this rank's block of a batch of ``n`` rows."""
        counts = self.row_counts(n)
        lo = sum(counts[:self.batch_rank])
        return lo, lo + counts[self.batch_rank]


def _default_tp(n: int) -> int:
    for cand in (4, 2):
        if n % cand == 0:
            return cand
    return 1


def _shape(n_devices: Optional[int], world_size: int,
           axis_names=("dp", "tp"), tp: Optional[int] = None,
           dcn: Optional[int] = None) -> dict:
    """The JAX ``make_mesh``'s shape for ``n_devices`` of ``world_size``."""
    n = min(n_devices or world_size, world_size)
    if n_devices and n < n_devices:
        raise ValueError(
            f"mesh wants {n_devices} devices but the world has {world_size} "
            f"process(es); start one process per device, e.g. torchrun "
            f"--nproc_per_node {n_devices}")
    if tp is not None and n % tp:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    if tp is None:
        tp = _default_tp(n)
    if dcn and dcn > 1:
        if n % (dcn * tp):
            raise ValueError(f"dcn={dcn} x tp={tp} does not divide device "
                             f"count {n}")
        return {"dcn": dcn, axis_names[0]: n // (dcn * tp), axis_names[1]: tp}
    return {axis_names[0]: n // tp, axis_names[1]: tp}


def mesh_shape(spec: Optional[str], world_size: int) -> Optional[dict]:
    """The mesh shape a ``--mesh`` flag names in a world of ``world_size``
    processes, or None for an empty flag (one device, no mesh).

    Grammar (axis sizes, innermost last), the JAX package's
    ``mesh_from_spec``: ``auto`` (every process, tp picked as 4 or 2 where
    it divides), ``N`` (N processes, tp picked likewise), ``dp,tp``,
    ``dcn,dp,tp``; ``x`` separates as ``,`` does. Sizes below 1, four
    parts, and more devices than the world has raise ``ValueError``."""
    if not spec:
        return None
    if str(spec).strip().lower() == "auto":
        return _shape(None, world_size)
    parts = [int(x) for x in str(spec).replace("x", ",").split(",")]
    if any(p < 1 for p in parts):
        raise ValueError(f"--mesh axis sizes must be >= 1: {spec!r}")
    if len(parts) == 1:
        return _shape(parts[0], world_size)
    if len(parts) == 2:
        dp, tp = parts
        return _shape(dp * tp, world_size, tp=tp)
    if len(parts) == 3:
        dcn, dp, tp = parts
        return _shape(dcn * dp * tp, world_size, tp=tp, dcn=dcn)
    raise ValueError(f"--mesh wants 'auto', N, dp,tp or dcn,dp,tp: {spec!r}")


def init_world() -> None:
    """Start the default process group if it is not up: from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), or a world of one process without it. ``nccl`` where
    a card is present, ``gloo`` on the CPU; under ``nccl`` the process takes
    the card ``LOCAL_RANK`` names. A caller that starts its own group
    (``gloo`` for two ranks on one card) does so before this."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@contextlib.contextmanager
def world_scope():
    """An entry point's run: a process group that the run starts (a
    ``--mesh`` flag) ends with it; one that was up before is left up."""
    was_up = dist.is_initialized()
    try:
        yield
    finally:
        if not was_up and dist.is_initialized():
            dist.destroy_process_group()


def is_main_rank() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process where no world is up."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(n_devices: Optional[int] = None, axis_names=("dp", "tp"),
              tp: Optional[int] = None, dcn: Optional[int] = None) -> Mesh:
    """The (dp, tp) — or (dcn, dp, tp) — mesh over the world's processes.

    ``tp`` defaults to 4 or 2, the largest that divides the count. The
    mesh spans the whole world: each process is one device, so a mesh of
    fewer devices than processes would leave processes without work, and
    one of more raises ``ValueError`` naming both counts."""
    init_world()
    world = dist.get_world_size()
    shape = _shape(n_devices, world, axis_names, tp, dcn)
    n = int(np.prod(list(shape.values())))
    if n != world:
        raise ValueError(f"mesh of {n} devices in a world of {world} "
                         "processes: the mesh spans every process")
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(shape)
    ranks = torch.arange(world).reshape(tuple(shape.values()))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    rank = dist.get_rank()
    coords = dict(zip(names, (int(c) for c in np.unravel_index(
        rank, tuple(shape.values())))))
    groups = {a: dm.get_group(a) for a in names}
    if "dcn" in shape:
        # every rank creates every batch group, in the same order
        by_tp = ranks.reshape(-1, shape[axis_names[1]])
        for j in range(by_tp.shape[1]):
            g = dist.new_group(by_tp[:, j].tolist())
            if j == coords[axis_names[1]]:
                groups["batch"] = g
    else:
        groups["batch"] = groups[axis_names[0]]
    return Mesh(shape, coords, groups, dm)


def mesh_from_spec(spec: Optional[str]) -> Optional[Mesh]:
    """The :class:`Mesh` a ``--mesh`` flag names (grammar of
    :func:`mesh_shape`), or None for an empty flag. The flag's shape is
    checked against the world before any group is made."""
    if not spec:
        return None
    init_world()
    shape = mesh_shape(spec, dist.get_world_size())
    return make_mesh(int(np.prod(list(shape.values()))), tp=shape["tp"],
                     dcn=shape.get("dcn"))


def apply_mesh_arg(model, spec: Optional[str]):
    """Place ``model`` on the mesh a ``--mesh`` flag names; a no-op for an
    empty flag, so that drivers call it unconditionally."""
    mesh = mesh_from_spec(spec)
    if mesh is not None:
        model.use_mesh(mesh)
    return model


def param_spec(shape, mesh, tp_axis: str = "tp") -> Optional[int]:
    """The dimension a parameter of torch ``shape`` shards on over the tp
    axis, or None (replicated): the JAX package's rule on the output
    dimension (flax's last, torch's first for ``nn.Linear`` and
    ``nn.Conv2d``) — a weight of rank >= 2 whose output dimension divides
    by tp and is at least 8·tp."""
    tp = mesh.shape[tp_axis]
    if len(shape) >= 2 and shape[0] % tp == 0 and shape[0] >= tp * 8:
        return 0
    return None


def heads_local(attn, mesh, tp_axis: str = "tp") -> bool:
    """Whether the attention block ``attn`` (``models.unet.Attention``)
    runs on each tp rank's own heads: its head count divides by tp and
    :func:`param_spec` shards all of ``to_q``, ``to_k`` and ``to_v``. Then
    those three keep their output local and the block gathers its
    attention output before ``to_out`` (``parallel/tp.py``); elsewhere
    (SDXL's 10 heads at tp = 4, a layer the rule leaves whole) every
    layer's output is gathered and the kernels see every head.

    The JAX package's counterpart is the kernels' partition rule,
    ``rich_text_to_image_tpu/ops/attention.py:570-580``: batch, heads and
    query rows may shard through a kernel, keys and values stay whole; the
    capture kernel, which averages over the heads, keeps them whole too
    (its ``_flash_avgp_cp``), as ``Attention.forward`` does."""
    tp = mesh.shape[tp_axis]
    return attn.heads % tp == 0 and all(
        param_spec(m.weight.shape, mesh, tp_axis) is not None
        for m in (attn.to_q, attn.to_k, attn.to_v))


def shard_params(unet, mesh, tp_axis: str = "tp"):
    """Shard ``unet``'s weights by :func:`param_spec` over the tp axis, in
    place (``parallel/tp.py``), the attention blocks that
    :func:`heads_local` admits on their own heads; nothing to do where tp
    is 1."""
    from ..models.unet import Attention
    from .tp import shard_module

    if mesh.shape[tp_axis] == 1:
        return unet
    local = set()
    for mod in unet.modules():
        if isinstance(mod, Attention) and heads_local(mod, mesh, tp_axis):
            local.update(id(m) for m in (mod.to_q, mod.to_k, mod.to_v))
    for mod in list(unet.modules()):
        if (isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d))
                and param_spec(mod.weight.shape, mesh, tp_axis) is not None):
            shard_module(mod, mesh.groups[tp_axis], mesh.coords[tp_axis],
                         mesh.shape[tp_axis], gather=id(mod) not in local)
    return unet


def batch_spec(mesh):
    """The process group over which a batch's rows split: this rank's
    (dcn, dp) ranks on a mesh with a dcn axis, else its dp group."""
    return mesh.groups["batch"]


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    group-rank order. A ``gloo`` group moves CUDA tensors through host
    memory (two ranks that share one card run under ``gloo``, which
    ``nccl`` refuses); the group's backend decides, read up front."""
    n = dist.get_world_size(group)
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    GATHERS["calls"] += 1
    GATHERS["elements"] += out.numel()
    return out.to(x.device) if host else out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group's ranks, in place where it can be; host
    staging under ``gloo`` as :func:`all_gather_cat`."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        y = x.cpu()
        dist.all_reduce(y, group=group)
        x.copy_(y)
        return x
    dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, counts: list, group) -> torch.Tensor:
    """The batch ranks' row blocks of ``counts`` rows each (this rank's is
    ``x``) in row order: each block padded to the longest, gathered, then
    trimmed, so that rows need not divide."""
    m = max(counts)
    if x.shape[0] < m:
        pad = x.new_zeros((m - x.shape[0], *x.shape[1:]))
        x = torch.cat([x, pad])
    full = all_gather_cat(x, 0, group)
    return torch.cat([full[i * m:i * m + c] for i, c in enumerate(counts)])
