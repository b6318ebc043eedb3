"""Piecewise CUDA graphs of the UNet's forward.

On the card a UNet call is paced by the host: Python launches some 1,400
kernels a call at SD-1.5 and 3,100 at SDXL, about 29 µs of host each. Here
the stretches of the forward that carry no control and no capture are
recorded once as CUDA graphs and replayed. Between them run eagerly, as
modules, every self-attention module (attn1) and the cross-attention
modules (attn2) and resnets that the call's controls or capture touch
(:func:`is_island`): their hooks, spans, per-call controls and captures act
as in the eager forward. An attn2 that nothing touches is inside a graph:
eagerly, its projections and the plain attention path cost about half a
millisecond of host a call.

**When.** A call takes the graphs where :func:`signature` admits it: a
CUDA input, grad mode off, the UNet's bfloat16 compute type, a host scalar
timestep and tensor inputs on the input's device, the convolution kernel's
gate off (its packed weights are made outside a capture), and no mesh
(``UNet2DCondition._graphs_on``, which ``MeshMixin.use_mesh`` clears). The
first call of a signature runs eagerly, so that cuDNN's and cuBLAS's
first-call choices are made outside a capture; the second captures its plan
and the later ones replay it. Anything else runs the eager forward as it is.

**A plan** is the list of steps of one call: copies of the call's tensor
inputs into static buffers (the timestep by a fill, with no host sync),
graph replays, and the eager islands, whose output is copied into the
static input of the graph after it. Stretches of the forward are captured
up to each island, so a graph's input is the static output of the graph
before it wherever that is its producer.

**Memory.** Every graph of every plan is captured into one pool, in call
order, and a plan's boundary tensors are held by non-owning views: between
calls the pool's blocks are free as the allocator counts them
(``max_memory_allocated`` does not see them; ``max_memory_reserved`` does),
and replay allocates nothing from the pool. That is sound because plans
never interleave and a plan replays in the order it was captured; for the
same reason whatever outlives a call (eps, and ``encode()``'s output under
encoder reuse) is copied out of the pool.

**Addresses.** A graph holds the addresses of the UNet's parameters. The
plans are dropped when those tensors are replaced: by ``.to()`` and the
like (``UNet2DCondition._apply``), and by a parameter registered anew on
one of its modules (``load_state_dict(assign=True)``, the mesh's
sharding), which a parameter-registration hook watches. An in-place
``load_state_dict`` keeps them valid.

Each call counts ``unet_graph`` in the tracer, one per graphable unit (the
stretches between islands), keyed ``how`` = ``replay`` | ``capture`` |
``eager``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..ops import conv as conv_ops
from ..utils import tracing

_REC = None  # the plan being captured; the islands hand over to it

# plan steps, by their first item
_GRAPH, _INPUT, _FILL, _ISLAND, _FORK = range(5)


def recording():
    """The capture in progress, or None (an eager forward)."""
    return _REC


# in a touched set: every cross-attention layer
EVERY_CROSS = "*.attn2"


def touched_layers(controls, capture, inject_resnet_name: str) -> set:
    """The cross-attention layers and resnets that a call's controls or
    capture act on, which run eagerly under the graphs: font-size weights
    and the full cross capture touch every attn2 (:data:`EVERY_CROSS`), a
    prompt-to-prompt blend or a cross capture its layers, the injection
    and the resnet capture their resnets (``ResnetBlock2D._injected``)."""
    out = set(capture.cross_probs) | set(capture.resnet)
    if capture.cross_full:
        out.add(EVERY_CROSS)
    if controls is not None:
        if (controls.token_weights is not None
                or controls.token_signs is not None):
            out.add(EVERY_CROSS)
        for d in (controls.inject_cross, controls.inject_resnet):
            if d is not None:
                out.update(d)
        if controls.inject_src is not None:
            out.add(inject_resnet_name)
    return out


def is_island(name: str, touched) -> bool:
    """Whether the layer ``name`` runs eagerly under a recording: every
    attn1 (the benchmark's hooks and the ``attn_self`` spans live there,
    and the injection and self capture act there), and the touched attn2
    layers and resnets."""
    if name.endswith(".attn1"):
        return True
    return name in touched or (name.endswith(".attn2")
                               and EVERY_CROSS in touched)


def _sig(x) -> tuple:
    return (tuple(x.shape), x.stride(), x.dtype, x.device)


def signature(unet, sample, timesteps, ehs, added_cond, enc, keep: bool,
              touched: set):
    """The plan key of a call, or None where the graphs do not apply."""
    dev = sample.device
    if not (unet._graphs_on and sample.is_cuda
            and not torch.is_grad_enabled()
            and unet.dtype == torch.bfloat16
            and not conv_ops.kernel_conv_enabled()):
        return None
    tensors = [ehs, *(added_cond or {}).values()]
    if enc is not None:
        tensors += [enc["x"], *enc["skips"]]
    if not (isinstance(timesteps, (int, float, np.number))
            and all(torch.is_tensor(t) and t.device == dev for t in tensors)):
        return None
    return ("decode" if enc is not None else "key" if keep else "forward",
            _sig(sample), torch.as_tensor(timesteps).dtype, _sig(ehs),
            tuple((k, _sig(v)) for k, v in sorted((added_cond or {}).items())),
            frozenset(touched))


def _meta(t: torch.Tensor) -> tuple:
    s = t.untyped_storage()
    return (s.data_ptr(), s.nbytes(), t.storage_offset(), tuple(t.shape),
            t.stride(), t.dtype, t.device)


def _view(meta) -> torch.Tensor:
    """A tensor over the memory ``meta`` describes that does not own it:
    it keeps no block of the allocator's alive."""
    ptr, nbytes, offset, size, stride, dtype, dev = meta
    st = torch._C._construct_storage_from_data_pointer(ptr, dev, nbytes)
    return torch.empty(0, dtype=dtype, device=dev).set_(st, offset, size,
                                                        stride)


# ------------------------------------------------- parameters replaced
_WATCHED: "weakref.WeakSet" = weakref.WeakSet()
_HOOK = []


def _on_parameter(module, name, param):
    for g in list(_WATCHED):
        if id(module) in g.module_ids:
            g.drop()


def _watch(graphs, unet) -> None:
    graphs.module_ids = frozenset(id(m) for m in unet.modules())
    _WATCHED.add(graphs)
    if not _HOOK:
        _HOOK.append(torch.nn.modules.module
                     .register_module_parameter_registration_hook(
                         _on_parameter))


def _release_capture_workspace() -> None:
    """Free cuBLAS's workspaces. cuBLAS keeps one for each stream it ran
    on; the capture stream's was allocated inside the pool and would stay
    allocated, counted by ``max_memory_allocated``, for the whole process.
    Freed, its block goes back to the pool: the captured GEMMs keep it as
    their scratch, which is sound for the reason the pool is (no pool
    memory is live across calls, and no tensor of the plan that took it
    lies there), and the next capture takes a workspace anew. The other
    streams' workspaces are taken anew from the allocator's cache at their
    next GEMM."""
    torch._C._cuda_clearCublasWorkspaces()


# ------------------------------------------------------------- capture
class _Recorder:
    """One call's capture: graphs captured up to each island, the islands
    run eagerly between them, and the steps that replay the call."""

    def __init__(self, pool, stream, touched):
        self.pool, self.stream, self.touched = pool, stream, touched
        self.steps: list = []
        self.pending: list = []  # (kind, buffer meta, source, where)
        self.graph = self._ctx = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self) -> None:
        """Close the open graph, fill its inputs and run it once."""
        g, self.graph = self.graph, None
        try:
            g.capture_end()
        finally:
            self._ctx.__exit__(None, None, None)
        for kind, meta, src, where in self.pending:
            buf = _view(meta)
            if kind == _ISLAND:  # an island's output, copied by its step
                buf.copy_(src)
                where[3] = buf
            elif kind == _INPUT:
                buf.copy_(src)
                self.steps.append((_INPUT, buf, where))
            else:
                buf.fill_(src)
                self.steps.append((_FILL, buf))
        self.pending.clear()
        g.replay()
        self.steps.append((_GRAPH, g))

    def abort(self) -> None:
        if self.graph is not None:
            g, self.graph = self.graph, None
            try:
                g.capture_end()
            except RuntimeError:
                pass
            self._ctx.__exit__(None, None, None)

    def stage(self, src: torch.Tensor, index: int) -> torch.Tensor:
        """A static buffer in the pool for call input ``index``."""
        buf = torch.empty_like(src)
        self.pending.append((_INPUT, _meta(buf), src, index))
        return buf

    def stage_scalar(self, value) -> torch.Tensor:
        """A 0-dim static buffer for a host scalar, filled by a kernel
        argument: no host-to-device copy, no sync."""
        buf = torch.empty((), dtype=torch.as_tensor(value).dtype,
                          device=self.stream.device)
        self.pending.append((_FILL, _meta(buf), value, None))
        return buf

    def island(self, module, args: tuple, controls, capture, aux):
        """Run ``module`` eagerly between two graphs: close the open graph,
        run the module's forward on its outputs, open the next graph and
        hand it a static buffer for the module's output."""
        global _REC
        self.end()
        _REC = None
        try:
            out = type(module).forward(module, *args, controls, capture, aux)
        finally:
            _REC = self
        step = [_ISLAND, module,
                tuple(_meta(a) if torch.is_tensor(a) else a for a in args),
                None, aux]
        self.steps.append(step)
        self.begin()
        buf = torch.empty_like(out)
        self.pending.append((_ISLAND, _meta(buf), out, step))
        return buf


class _Plan:
    __slots__ = ("steps", "n_graphs", "eps", "enc")


class UNetGraphs:
    """The plans of one UNet, keyed by :func:`signature`, and their pool."""

    def __init__(self):
        self.plans: dict = {}
        self.seen: set = set()
        self.pool = self.stream = None
        self.module_ids = frozenset()

    def drop(self) -> None:
        """Forget every plan and signature; the pool goes with them."""
        self.plans.clear()
        self.seen.clear()
        self.pool = None

    def call(self, unet, key, sample, timesteps, ehs, controls, capture,
             added_cond, enc):
        """The call by its plan: eager on a signature's first call,
        captured on its second, replayed after. Returns (eps, aux,
        encode()'s output or None)."""
        plan = self.plans.get(key)
        if plan is not None:
            tracing.count("unet_graph", plan.n_graphs, how="replay")
            return self._replay(plan, sample, timesteps, ehs, controls,
                                capture, added_cond, enc)
        if key not in self.seen:
            self.seen.add(key)
            out = unet._run(sample, timesteps, ehs, controls, capture,
                            added_cond, enc)
            if tracing.enabled():
                tracing.count("unet_graph", unet._graph_units(
                    key[-1], enc is not None), how="eager")
            return out
        plan, out = self._capture(unet, key, sample, timesteps, ehs,
                                  controls, capture, added_cond, enc)
        self.plans[key] = plan
        tracing.count("unet_graph", plan.n_graphs, how="capture")
        return out

    @staticmethod
    def _inputs(sample, ehs, added_cond, enc) -> list:
        """The call's tensor inputs, in the order of the plan's copies."""
        ins = [sample, ehs] + [v for _, v in sorted(
            (added_cond or {}).items())]
        if enc is not None:
            ins += [enc["x"], *enc["skips"]]
        return ins

    def _capture(self, unet, key, sample, timesteps, ehs, controls,
                 capture, added_cond, enc):
        global _REC
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device=sample.device)
            _watch(self, unet)
        rec = _Recorder(self.pool, self.stream, key[-1])
        ins = self._inputs(sample, ehs, added_cond, enc)
        _REC = rec
        try:
            rec.begin()
            st = [rec.stage(x, i) for i, x in enumerate(ins)]
            t = rec.stage_scalar(timesteps)
            added = (None if added_cond is None
                     else dict(zip(sorted(added_cond), st[2:])))
            s_enc = None
            if enc is not None:
                n = len(enc["skips"])
                s_enc = {"x": st[-n - 1], "skips": tuple(st[-n:]),
                         "aux": enc["aux"]}
            eps, aux, enc_out = unet._run(st[0], t, st[1], controls, capture,
                                          added, s_enc)
            rec.end()
        except BaseException:
            rec.abort()
            raise
        finally:
            _REC = None
        _release_capture_workspace()
        plan = _Plan()
        plan.n_graphs = sum(s[0] == _GRAPH for s in rec.steps)
        plan.eps = _view(_meta(eps))
        keep = key[0] == "key"
        plan.enc = ((_view(_meta(enc_out["x"])),
                     tuple(_view(_meta(s)) for s in enc_out["skips"]))
                    if keep else None)
        # the islands of encode() write into its own aux; decode() forks it
        # before its first island
        steps, forked = [], enc is not None
        for s in rec.steps:
            if s[0] == _ISLAND:
                if not forked and s[4] is not enc_out["aux"]:
                    steps.append((_FORK,))
                    forked = True
                s = (_ISLAND, s[1], tuple(_view(a) if isinstance(a, tuple)
                                          else a for a in s[2]), s[3])
            steps.append(s)
        plan.steps = steps
        out_enc = None
        if keep:
            out_enc = {"x": enc_out["x"].clone(), "aux": enc_out["aux"],
                       "skips": tuple(s.clone() for s in enc_out["skips"])}
        return plan, (eps.clone(), aux, out_enc)

    def _replay(self, plan, sample, timesteps, ehs, controls, capture,
                added_cond, enc):
        ins = self._inputs(sample, ehs, added_cond, enc)
        if isinstance(timesteps, np.generic):
            timesteps = timesteps.item()
        if enc is None:
            aux = aux_e = {}
        else:
            aux_e = enc["aux"]
            aux = {k: dict(v) for k, v in aux_e.items()}
        for s in plan.steps:
            op = s[0]
            if op == _GRAPH:
                s[1].replay()
            elif op == _ISLAND:
                s[3].copy_(s[1](*s[2], controls, capture, aux))
            elif op == _INPUT:
                s[1].copy_(ins[s[2]])
            elif op == _FILL:
                s[1].fill_(timesteps)
            else:
                aux = {k: dict(v) for k, v in aux_e.items()}
        out_enc = None
        if plan.enc is not None:
            out_enc = {"x": plan.enc[0].clone(), "aux": aux_e,
                       "skips": tuple(s.clone() for s in plan.enc[1])}
        return plan.eps.clone(), aux, out_enc
