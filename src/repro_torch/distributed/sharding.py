"""Logical-axis sharding (port of ``repro.distributed.sharding``, DESIGN.md
§5): model code names axes, a rule table maps them to mesh axes.

Model code calls ``logical(x, "batch", "seq", "ff")``.  Outside a sharding
context this is the identity (every one-device path, the decode step and
its captured graphs included).  Inside :func:`use_sharding` it
redistributes a DTensor to the placements the rule table gives those
names, where the reference adds a ``with_sharding_constraint``: the port
runs on ``torch.distributed``'s ``DeviceMesh`` and DTensor, so a spec
becomes a list of ``Shard`` / ``Replicate`` placements
(:func:`to_placements`).  The rule tables are the reference's:

  * TRAIN_RULES — DP over (pod, data), Megatron TP over model
    (heads/ff/vocab/experts), optional sequence parallelism.
  * SERVE_RULES — batch over (pod, data), heads over model; long-context
    (batch=1) cells switch ``kv_seq`` to data (context parallelism).

A spec is the port's :class:`P`: a tuple with one entry a tensor dim,
each None, a mesh axis name, or a tuple of names (``("pod", "data")``
shards the dim over both, pod major, as JAX lays out a multi-axis entry).
The plans take either a ``DeviceMesh`` or an :class:`AbstractMesh` (axis
names and sizes only), so they can be built for the production meshes on
one host.  The reference's ``shard_map_compat`` (a JAX version shim for
partial ``shard_map``) has no counterpart: the port's manual-axis code
(``int8_allreduce_pod``, ``pipeline_forward``) talks to the process group
of one mesh dim (``mesh["pod"].get_group()``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from ..tree import tree_map, tree_map_with_path

Axis = Union[None, str, Tuple[str, ...]]

TRAIN_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "d": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "cap": None,
    "state": None,
}

SERVE_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "d": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "cap": None,
    "state": None,
}

# long-context decode, batch=1: shard the KV sequence over (pod, data)
LONG_SERVE_RULES = dict(SERVE_RULES, batch=None, kv_seq=("pod", "data"))

# batch=1 with the packed cache replicated (SKVQ makes that affordable):
# nothing batch/seq-sharded; TP only
REPL_SERVE_RULES = dict(SERVE_RULES, batch=None, kv_seq=None)

# sequence-parallel training (hillclimb lever): norms/elementwise run
# seq-sharded over the model axis, cutting TP all-gather volume
SEQ_PARALLEL_TRAIN_RULES = dict(TRAIN_RULES, seq="model")


class P(tuple):
    """A partition spec: one entry a tensor dim (None, an axis name, or a
    tuple of names); trailing dims past its length are unsharded."""

    def __new__(cls, *parts: Axis):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names without devices (``jax.sharding.
    AbstractMesh``): enough to build every plan of this module and
    ``launch.shardings`` for a mesh of any size on one host."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (a ``DeviceMesh``'s ``mesh_dim_names``)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass
class ShardingCtx:
    mesh: Optional[object] = None
    rules: Optional[Dict[str, Axis]] = None


_TLS = threading.local()


def _ctx() -> ShardingCtx:
    if not hasattr(_TLS, "ctx"):
        _TLS.ctx = ShardingCtx()
    return _TLS.ctx


@contextlib.contextmanager
def use_sharding(mesh, rules: Dict[str, Axis]):
    prev = _ctx().mesh, _ctx().rules
    _TLS.ctx = ShardingCtx(mesh, None if rules is None else dict(rules))
    try:
        yield
    finally:
        _TLS.ctx = ShardingCtx(*prev)


def current_rules() -> Optional[Dict[str, Axis]]:
    return _ctx().rules


@contextlib.contextmanager
def sharded_region(mesh, rules: Dict[str, Axis]):
    """What a step over DTensors runs under: :func:`use_sharding` and
    DTensor's ``implicit_replication`` (a plain tensor beside a DTensor,
    such as a RoPE table, a causal mask or an ``arange``, is the same on
    every rank and counts as replicated).  A no-op when ``mesh`` is None."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    # DTensor's ``implicit_replication()`` switch, restored on the way out
    # (the context manager resets it to False, which would end an
    # enclosing region early)
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        with use_sharding(mesh, rules):
            yield
    finally:
        disp._allow_implicit_replication = prev


def carry_context(fn):
    """``fn`` re-entering the sharding context current when it was
    wrapped, wherever it is called: activation checkpointing recomputes a
    block in the backward pass, which may run on another thread (CUDA's
    autograd threads) and outside the ``with``.  ``fn`` itself outside a
    context."""
    ctx = _ctx()
    if ctx.mesh is None:
        return fn
    mesh, rules = ctx.mesh, ctx.rules

    def wrapped(*args, **kw):
        with sharded_region(mesh, rules):
            return fn(*args, **kw)
    return wrapped


def current_mesh():
    return _ctx().mesh


def _axes_in_mesh(axis: Axis, mesh) -> Axis:
    """Drop mesh axes that don't exist (single-pod mesh has no 'pod')."""
    names = axis_names(mesh)
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in names else None
    kept = tuple(a for a in axis if a in names)
    return kept if kept else None


def spec_for(*names: Optional[str]) -> P:
    ctx = _ctx()
    assert ctx.rules is not None
    parts = []
    for n in names:
        a = None if n is None else ctx.rules.get(n)
        parts.append(_axes_in_mesh(a, ctx.mesh))
    return P(*parts)


def axis_size(mesh, axes: Axis) -> int:
    """The number of shards ``axes`` (None, a name or a tuple) cut a dim
    into on ``mesh``."""
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= shape[a]
    return n


def layout_mesh(mesh):
    """(the ``DeviceMesh`` the port's DTensors live on, the mesh axes each
    of its dims stands for).  Where the mesh has a ``pod`` axis just
    before ``data``, the two are one layout dim (``"dp"``, pod major):
    every rule and plan names them together (the batch and the FSDP dim
    take ``("pod", "data")``), so each rank holds the same shards as on
    the full mesh, and DTensor's sharding propagation, whose search grows
    with the mesh's dims, runs over two dims instead of three.  The
    ``pod`` axis alone (the int8 wire, the pipeline) is reached through
    ``mesh.get_group("pod")``.  Any other mesh is its own layout."""
    names = axis_names(mesh)
    if not ("pod" in names and "data" in names
            and names.index("data") == names.index("pod") + 1):
        return mesh, tuple((n,) for n in names)
    if not hasattr(mesh, "_repro_layout"):   # built once a mesh: its groups
        from torch.distributed.device_mesh import DeviceMesh
        ip = names.index("pod")
        shape = list(mesh.mesh.shape)
        ranks = mesh.mesh.reshape(shape[:ip] + [shape[ip] * shape[ip + 1]]
                                  + shape[ip + 2:])
        lnames = names[:ip] + ("dp",) + names[ip + 2:]
        groups = tuple((n,) for n in names[:ip]) + (("pod", "data"),) + \
            tuple((n,) for n in names[ip + 2:])
        mesh._repro_layout = (DeviceMesh(mesh.device_type, ranks,
                                         mesh_dim_names=lnames), groups)
    return mesh._repro_layout


def to_placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``'s layout mesh
    (:func:`layout_mesh`): ``Shard(d)`` on every layout dim that tensor
    dim ``d``'s entry names, ``Replicate()`` on the others.  A dim split
    over several mesh dims is split in mesh-dim order, the first named
    outermost, which is JAX's major-to-minor layout when the entry names
    them in mesh order (the ``dp`` layout dim is pod major for the same
    reason)."""
    from torch.distributed.tensor import Replicate, Shard
    _, groups = layout_mesh(mesh)
    out = [Replicate() for _ in groups]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx, k = [], 0
        while k < len(axes):
            g = next((i for i, grp in enumerate(groups)
                      if axes[k:k + len(grp)] == grp), None)
            if g is None:
                raise ValueError(f"spec entry {entry} does not split into "
                                 f"the layout's mesh dims {groups}")
            idx.append(g)
            k += len(groups[g])
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh axes out of the "
                             f"mesh's order {groups}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axes {groups[i]} shard two dims "
                                 f"in {spec}")
            out[i] = Shard(d)
    return out


def distribute(x: torch.Tensor, spec: P, mesh):
    """``x`` (the full tensor, equal on every rank) as a DTensor laid out
    by ``spec``: each rank keeps its own shard; nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, layout_mesh(mesh)[0],
                             to_placements(spec, mesh), src_data_rank=None)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    def place(self, x: torch.Tensor):
        """The full tensor ``x`` laid out by this sharding."""
        return distribute(x, self.spec, self.mesh)


def redistribute(x, spec: P, mesh):
    """The DTensor ``x`` laid out by ``spec`` (itself if it already is);
    differentiable, as DTensor's redistribute is."""
    want = to_placements(spec, mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(layout_mesh(mesh)[0], want)


def logical(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by logical axis names (identity without a context).

    Inside :func:`use_sharding`, a DTensor is redistributed to the rules'
    placements (a plain tensor is left as it is).  Axes whose size doesn't
    divide the mesh extent are dropped: forcing e.g. 4 kv-heads onto a
    16-way model axis makes GSPMD pad-and-reduce (measured as a 17 GB/step
    all-reduce on gemma3 long-context decode in the reference)."""
    ctx = _ctx()
    if ctx.mesh is None or ctx.rules is None:
        return x
    if x.ndim != len(names):
        raise ValueError(f"rank {x.ndim} vs {names}")
    spec = spec_for(*names)
    dims = [ax if ax is None or x.shape[i] % axis_size(ctx.mesh, ax) == 0
            else None for i, ax in enumerate(spec)]
    if not is_dtensor(x):
        return x
    # a mesh axis two names map to (``seq`` and ``heads`` under sequence
    # parallelism) splits the last of their dims: the heads, the ff or
    # the vocab shard of a product, whose sequence is whole
    used = set()
    for i in reversed(range(len(dims))):
        axes = () if dims[i] is None else (
            (dims[i],) if isinstance(dims[i], str) else tuple(dims[i]))
        if used & set(axes):
            dims[i] = None
        used |= set(axes)
    return redistribute(x, P(*dims), ctx.mesh)


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, ...) with its sequence dim whole on every rank: under
    sequence parallelism (``rules["seq"]`` set) the all-gather before a
    product with a column-split weight, whose flattened rows DTensor
    cannot propagate when the batch and the sequence are both split.
    ``x`` itself where its sequence is not split or outside a context."""
    if not is_sharded(x) or x.ndim < 3:
        return x
    return _seq_unsplit(x)


def seq_whole_grad(y: torch.Tensor) -> torch.Tensor:
    """``y`` (B, S, ...), whose gradient is laid out by :func:`seq_whole`
    on its way back: the output of a layer that flattens a whole
    sequence's tokens (the MoE dispatch), met by a sequence-split
    gradient under sequence parallelism."""
    if not is_sharded(y) or y.ndim < 3 or not torch.is_grad_enabled():
        return y
    return _SeqWholeGrad.apply(y)


def _seq_unsplit(x):
    from torch.distributed.tensor import Replicate, Shard
    pls = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
           for pl in x.placements]
    if pls == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pls)


class _SeqWholeGrad(torch.autograd.Function):
    """The identity, whose backward lays its gradient out as
    :func:`seq_whole` does."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _seq_unsplit(g) if is_dtensor(g) else g


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor inside a sharding context."""
    return _ctx().mesh is not None and is_dtensor(x)


def spec_of(x) -> P:
    """The spec of a DTensor's layout (the inverse of
    :func:`to_placements`): each tensor dim's entry names the mesh axes of
    the layout dims that shard it, in mesh order."""
    from torch.distributed.tensor import Shard
    _, groups = layout_mesh(_ctx().mesh)
    parts = [() for _ in range(x.ndim)]
    for grp, pl in zip(groups, x.placements):
        if isinstance(pl, Shard):
            parts[pl.dim] = parts[pl.dim] + grp
    return P(*[None if not a else (a[0] if len(a) == 1 else a)
               for a in parts])


def whole_heads(y: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``y`` (..., n_heads * head_dim) laid out so that splitting its last
    dim into heads needs no other rank's data: the last dim is gathered
    over each mesh dim whose shards do not hold whole heads (8 kv heads
    over a 16-way ``model`` axis; GSPMD pads such a split, DTensor refuses
    it).  ``y`` itself where nothing needs gathering or outside a
    context."""
    if not is_sharded(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    lmesh = layout_mesh(_ctx().mesh)[0]
    last = y.ndim - 1
    pls, n = list(y.placements), 1
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard) and pl.dim == last:
            n *= lmesh.size(i)
            if n_heads % n:
                pls[i] = Replicate()
    if pls == list(y.placements):
        return y
    return y.redistribute(lmesh, pls)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """``o`` (..., n_heads, head_dim) -> (..., n_heads * head_dim).  On a
    mesh, ``o`` is first gathered over any mesh dim that splits its head
    dim or splits its heads unevenly, and the gradient that comes back to
    the merged dim (sharded over ``model`` by the next product's weight)
    is gathered to whole heads (:func:`whole_heads`), so that splitting
    it back into heads needs no other rank's data."""
    if not is_sharded(o):
        return o.reshape(*o.shape[:-2], -1)
    from torch.distributed.tensor import Replicate, Shard
    lmesh = layout_mesh(_ctx().mesh)[0]
    n, last = o.shape[-2], o.ndim - 1
    # the merge needs the head dim split into whole shards and the head
    # dim itself whole (DTensor's propagation may have split either)
    pls = [Replicate() if isinstance(pl, Shard) and lmesh.size(i) > 1 and (
        pl.dim == last or (pl.dim == last - 1 and n % lmesh.size(i)))
        else pl for i, pl in enumerate(o.placements)]
    if pls != list(o.placements):
        o = o.redistribute(lmesh, pls)
    y = o.reshape(*o.shape[:-2], -1)
    return _WholeHeadsGrad.apply(y, n) if torch.is_grad_enabled() else y


class _WholeHeadsGrad(torch.autograd.Function):
    """The identity, whose backward lays its gradient out as
    :func:`whole_heads` does."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.n = n
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_heads(g, ctx.n), None


def shard_count(spec: P) -> int:
    """Distinct shards ``spec`` cuts a tensor into on the current mesh."""
    mesh, n = _ctx().mesh, 1
    for entry in spec:
        n *= axis_size(mesh, entry)
    return n


def local_scale() -> int:
    """Inside :func:`run_local`'s function, how many distinct shards its
    output has (each rank computes one of them; 1 elsewhere): an op
    counter multiplies what it sees there by this to get the global
    count."""
    return getattr(_TLS, "local_scale", 1)


@contextlib.contextmanager
def local_scaled(n: int):
    """Multiply :func:`local_scale` by ``n`` inside (a part of a local
    function whose work differs across ``n`` more ranks than its output
    does, such as a context-parallel shard's partial before its
    merge)."""
    prev = local_scale()
    _TLS.local_scale = prev * n
    try:
        yield
    finally:
        _TLS.local_scale = prev


def mesh_group(axes):
    """The process group of the layout mesh dim that stands for mesh
    ``axes`` (a name or a tuple), as the functional collectives take it:
    ``(layout mesh, dim)``."""
    lmesh, groups = layout_mesh(_ctx().mesh)
    want = (axes,) if isinstance(axes, str) else tuple(axes)
    for i, grp in enumerate(groups):
        if grp == want:
            return lmesh, i
    raise ValueError(f"mesh axes {want} are not one layout dim of {groups}")


def local_index(axes) -> int:
    """This rank's shard index along mesh ``axes`` (a name or a tuple,
    the first major), as a dim split over them is laid out."""
    mesh = _ctx().mesh
    shape = mesh_shape(mesh)
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        idx = idx * shape[a] + coord[names.index(a)]
    return idx


def _to_dtensor(out, spec: P, mesh):
    from torch.distributed.tensor import DTensor
    out = out.contiguous()
    shape = list(out.shape)
    for d, entry in enumerate(spec):
        shape[d] *= axis_size(mesh, entry)
    return DTensor.from_local(out, layout_mesh(mesh)[0],
                              to_placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def run_local(fn, args, specs, out_spec, shards: Optional[int] = None):
    """``fn`` over the local shards of the DTensors ``args``, each laid
    out by its spec first (a spec of None passes its argument on as it
    is: a plain tensor, None, or a DTensor's own local shard, unmoved, so
    that ``fn`` may write it in place), its output taken as the shards of
    a DTensor laid out by ``out_spec`` (the layout the specs make each
    rank's output hold).  An output that is a tuple or a dict of tensors
    takes a tuple or a dict of specs, or a function of (key, local
    tensor) giving each one's.  For an op whose shards need no other
    rank's data (attention over whole heads of whole sequences, a cache's
    quantization and append): DTensor never propagates its sharding, and
    with autograd on both local maps are differentiable.  ``shards``: the
    distinct shards the output has (:func:`local_scale`; by default
    ``out_spec``'s count, which a tree of specs must then give as its
    first leaf)."""
    mesh = _ctx().mesh
    grad = torch.is_grad_enabled()
    local = []
    for a, s in zip(args, specs):
        if not is_dtensor(a):
            local.append(a)
        elif s is None:
            local.append(a._local_tensor)
        else:
            t = redistribute(a, s, mesh).to_local()
            local.append(_ContiguousGrad.apply(t) if grad else t)
    if shards is None:
        first = out_spec
        while not isinstance(first, P):
            first = next(iter(first.values() if isinstance(first, dict)
                              else first))
        shards = shard_count(first)
    with local_scaled(shards):
        out = fn(*local)

    def wrap(key, o, s):
        return _to_dtensor(o, s(key, o) if callable(s) else s, mesh)
    if isinstance(out, dict):
        return {k: wrap(k, o, out_spec if callable(out_spec)
                        else out_spec[k]) for k, o in out.items()}
    if isinstance(out, tuple):
        return tuple(wrap(i, o, out_spec if callable(out_spec)
                          else out_spec[i]) for i, o in enumerate(out))
    return wrap(None, out, out_spec)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    DTensor's gradient shards must be laid out as its global stride says,
    and a local op's gradient need not be."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ------------------------------------------------------------ param specs

# parameter partition rules by key-path suffix (Megatron TP + EP); tried in
# order, first match wins. ZeRO-1 additionally shards optimizer state along
# 'data' (see training.optim).
_PARAM_RULES = (
    ("wq", P(None, None, "model")),
    ("wk", P(None, None, "model")),
    ("wv", P(None, None, "model")),
    ("wo_attn", P(None, "model", None)),
    ("bq", P(None, "model")),
    ("bk", P(None, "model")),
    ("bv", P(None, "model")),
    ("wi_gate", P(None, None, "model")),
    ("wi_up", P(None, None, "model")),
    ("wo", P(None, "model", None)),
    ("experts_gate", P(None, "model", None, None)),   # (L, E, D, f)
    ("experts_up", P(None, "model", None, None)),
    ("experts_down", P(None, "model", None, None)),   # (L, E, f, D)
    ("router", P(None, None, None)),
    ("embed", P("model", None)),
    ("lm_head", P(None, "model")),
    # rwkv6 / mamba big projections
    ("w_rkvg", P(None, None, "model")),
    ("w_out", P(None, "model", None)),
    ("in_proj", P(None, None, "model")),
    ("out_proj", P(None, "model", None)),
)


def param_partition_specs(params, mesh):
    """Spec tree for a param tree (leaves with ``.shape``/``.ndim``), by
    key-name rules."""
    names = axis_names(mesh)

    def spec_of(path, leaf):
        name = path[-1]
        for suffix, spec in _PARAM_RULES:
            if name == suffix:
                ok = len(spec) == leaf.ndim and all(
                    a is None or a in names for a in spec)
                if ok:
                    return spec
                # specs above assume a leading stacked-layer dim; tolerate
                # unstacked variants by trimming the leading None
                if len(spec) == leaf.ndim + 1 and spec[0] is None:
                    trimmed = P(*spec[1:])
                    if all(a is None or a in names for a in trimmed):
                        return trimmed
        return P()  # replicate

    return tree_map_with_path(spec_of, params)


def named_shardings(params, mesh):
    """:func:`param_partition_specs` as a tree of :class:`NamedSharding`."""
    return tree_map(lambda s: NamedSharding(mesh, s),
                    param_partition_specs(params, mesh))
