"""Op-level cost counter: FLOPs and bytes by category over one traced call
(counterpart of ``repro.launch.jaxpr_cost``, which walks a jaxpr).

:class:`OpCounter` is a ``TorchDispatchMode``: every aten op a call
dispatches is counted as it runs, under the reference's conventions
(``jaxpr_cost.py:25-36, 101-115``):

  * matmul (``mm``/``bmm``/``addmm``/``baddbmm``): 2·batch·M·N·K FLOPs;
    bytes of the inputs plus the outputs (a fusion boundary);
  * convolution: 2·out·(weight elements per output channel) FLOPs, the
    reference's ``_conv_flops``; bytes as a matmul;
  * ops that only move data (copies, casts, cat, index, gather, scatter,
    pad, where/masked_fill, bitwise logic, fills): their output bytes
    (the bytes written, for an in-place write through an index);
  * views: nothing;
  * everything else: one FLOP an output element (``_ELT_FLOPS`` weights)
    plus the output bytes (elementwise chains fuse, so each intermediate
    crosses memory once).

Layers run as a Python loop in the port, so trip counts are exact with no
scan multiplier, and a backward pass counts because autograd runs its ops
under the mode.  Ops on DTensors are counted at their global shapes;
ops on the local shards inside ``sharding.run_local`` are scaled by the
shards the region's output has (``sharding.local_scale``), so a count is
GLOBAL either way: divide by the device count for per-device terms, as
the reference does.  Collectives (``_c10d_functional``/``c10d`` ops) are
not compute and are left to ``roofline.CollectiveCounter``.

The hand-written kernels are ctypes launches no dispatch mode sees: each
entry point (``kernels.decode_attn.decode_attn``, ``kernels.kv_quant``'s
``kv_quant``, ``kv_append``, ``kv_append_chunk``) reports its own cost
through :func:`kernel_cost` from its arguments (its planes read once and
its outputs written once, the byte formula behind PERF.md §6's bounds,
and its f32 operations), under the category ``kernel:<name>``, and the
ops inside (the plain twin's, or the launch's own allocations) are not
counted: a step's count is the same work whichever implements it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_ELT_FLOPS = {
    "exp": 1, "tanh": 1, "log": 1, "sigmoid": 1, "erf": 1, "rsqrt": 1,
    "sqrt": 1, "sin": 1, "cos": 1, "pow": 1, "div": 1,
}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
_CONV = {"convolution", "_convolution"}
_MOVE = {
    "_to_copy", "copy", "copy_", "clone", "cat", "stack", "index",
    "index_select", "gather", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "index_put", "index_put_", "_index_put_impl_",
    "constant_pad_nd", "embedding", "where", "masked_fill",
    "masked_fill_", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "bitwise_left_shift", "bitwise_right_shift",
    "__lshift__", "__rshift__", "logical_and", "logical_or", "logical_not",
    "fill", "fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "repeat", "repeat_interleave", "slice_scatter", "select_scatter",
    "roll", "flip", "tril", "triu", "_unsafe_index",
}
# in-place writes through an index: the bytes written are the values'
_WRITE_ARG = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
              "scatter": 3, "scatter_": 3, "scatter_add": 3,
              "scatter_add_": 3}
_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "resize_", "set_", "record_stream", "item",
    "_to_dense", "is_same_size", "_has_compatible_shallow_copy_type",
    "_unsafe_view",
}
_COMM_NAMESPACES = {"_c10d_functional", "c10d", "_c10d_functional_autograd",
                    "_dtensor"}

_TLS = threading.local()


def _active():
    if not hasattr(_TLS, "stack"):
        _TLS.stack = []
    return _TLS.stack


def _nbytes(t) -> float:
    if not isinstance(t, torch.Tensor):
        return 0.0
    return float(t.numel()) * t.element_size()


def _out_tensors(out):
    flat, _ = tree_flatten(out)
    return [t for t in flat if isinstance(t, torch.Tensor)]


def _mm_flops(name: str, args) -> float:
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    batch = a.shape[0] if a.ndim == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    return 2.0 * batch * m * n * k


def _conv_flops(args, out) -> float:
    w = args[1]
    per_out = w.numel() // max(w.shape[0], 1)
    return 2.0 * out.numel() * max(per_out, 1)


class OpCounter(TorchDispatchMode):
    """Counts ``{"flops", "bytes"}`` by category over what runs inside it
    (``with OpCounter() as c: fn(...)``); ``c.counts`` holds
    ``{category: {"flops", "bytes", "ops"}}``, :meth:`totals` their sums.
    Categories: ``matmul``, ``conv``, ``move``, ``elementwise`` and
    ``kernel:<name>`` (:func:`kernel_cost`)."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, Dict[str, float]] = {}
        self._suspended = 0

    def __enter__(self):
        _active().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active().remove(self)
        return super().__exit__(*exc)

    def add(self, category: str, flops: float, nbytes: float,
            ops: int = 1) -> None:
        c = self.counts.setdefault(category, {"flops": 0.0, "bytes": 0.0,
                                              "ops": 0})
        c["flops"] += flops
        c["bytes"] += nbytes
        c["ops"] += ops

    def totals(self) -> Dict[str, float]:
        return {"flops": sum(c["flops"] for c in self.counts.values()),
                "bytes": sum(c["bytes"] for c in self.counts.values())}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            self._count(func, types, args, out)
        return out

    def _count(self, func, types, args, out) -> None:
        if not isinstance(func, torch._ops.OpOverload):
            return
        if func.namespace in _COMM_NAMESPACES:
            return
        name = func._overloadpacket.__name__
        if name in _FREE or (func.is_view and name not in _MOVE):
            return
        outs = _out_tensors(out)
        if not outs:
            return
        from ..distributed.sharding import local_scale
        from torch.distributed.tensor import DTensor
        scale = 1 if any(issubclass(t, DTensor) for t in types) \
            else local_scale()
        out_b = sum(_nbytes(t) for t in outs)
        if name in _MATMUL:
            in_b = sum(_nbytes(a) for a in args if isinstance(a, torch.Tensor))
            self.add("matmul", scale * _mm_flops(name, args),
                     scale * (in_b + out_b))
        elif name in _CONV:
            in_b = sum(_nbytes(a) for a in args if isinstance(a, torch.Tensor))
            self.add("conv", scale * _conv_flops(args, outs[0]),
                     scale * (in_b + out_b))
        elif name in _MOVE:
            if name in _WRITE_ARG and len(args) > _WRITE_ARG[name]:
                out_b = _nbytes(args[_WRITE_ARG[name]]) or out_b
            elif name == "copy_":
                out_b = _nbytes(args[0])
            self.add("move", 0.0, scale * out_b)
        else:
            self.add("elementwise",
                     scale * outs[0].numel() * _ELT_FLOPS.get(name, 1),
                     scale * out_b)


@contextlib.contextmanager
def kernel_cost(name: str, cost):
    """A hand-written kernel's entry point: report ``cost()`` (its
    ``(flops, bytes)``, computed only when a counter is active, and with
    the counters off, as the formula may read a small tensor back) to
    every active counter under ``kernel:<name>``, scaled as a local op
    is, and count none of the ops inside."""
    stack = [c for c in _active() if not c._suspended]
    for c in stack:
        c._suspended += 1
    try:
        if stack:
            from ..distributed.sharding import local_scale
            flops, nbytes = cost()
            s = local_scale()
            for c in stack:
                c.add(f"kernel:{name}", s * flops, s * nbytes)
        yield
    finally:
        for c in stack:
            c._suspended -= 1


def cost_of_fn(fn, *args, **kwargs) -> Dict[str, float]:
    """``{"flops", "bytes"}`` of one call ``fn(*args, **kwargs)``, global
    (the reference's ``cost_of_fn``)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.totals()
