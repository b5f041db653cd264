"""The sharding of the LM stack on a :class:`Mesh` (``launch/mesh.py``):
what GSPMD derives from the reference's sharding rules, written out as
collectives that ``models/model.py``'s one stack calls through a
:class:`_Sharding` (trivial for a model on one device: every collective
is then the identity and every block runs as it is).

Every rank holds its shard of each parameter under ``param_specs`` and
its rows of the batch (dim 0 split over the data axes). Between layers
the activations are replicated over ``model`` (or split over the
sequence there, with a sequence-parallel hook). A block whose weights
the rules split evenly runs split over ``model``:

* attention, when the query and kv heads divide the axis: each rank runs
  its heads (``wq``/``wk``/``wv`` columns, ``wo`` rows), then the partial
  outputs are summed (Megatron's column- then row-parallel pair);
* the MLP: ``w1``/``w3`` columns, ``w2`` rows, then a sum;
* the MoE layer (expert parallel): the router and the dispatch run on
  the tokens of the whole data group (gathered, so capacity and drops
  are the single-device ones), each rank runs its experts on its slice
  of the buffer, and the expert outputs are gathered for the combine;
* the Mamba and RG-LRU blocks: their channels (``ssm_block`` and
  ``rglru_block`` with ``split=``).

Any other block (heads that do not divide the axis, an axis the rules
dropped) gathers its weights over ``model`` and runs whole on every
rank. The embedding and the head are split over the vocabulary: a masked
lookup summed over ``model``, and a cross-entropy whose max, sum of
exponentials and picked logit are reduced over ``model``.

The collectives are ``torch.autograd.Function``s whose backward is the
matching collective, so autograd gives each rank the gradient of its
shard: what stays to reduce over the data axes is left to the train
step (``models/train.py``), whose loss on each rank is its rows' share
of the global mean, so the data ranks' gradients sum to the
single-device gradient.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .config import ModelConfig
from .layers import attention, mlp
from .moe import moe_combine, moe_dispatch, moe_experts
from .sharding import _spec_for_name, data_axes

__all__ = ["gather_params", "gather_tree", "full_shapes", "vocab_split"]


# ---------------------------------------------------------- collectives

def _chunk(t, mesh, axes, dim):
    n = mesh.axis_size(axes)
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.axis_index(axes) * size, size)


class _Copy(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``axes`` (the input
    of a region split over them)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    """The sum over ``axes`` (the output of a split region); the backward
    is the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Scatter(torch.autograd.Function):
    """This rank's chunk on ``dim`` of a replicated tensor; the backward
    gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(x, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axes, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    """The chunks on ``dim`` gathered over ``axes``, for a consumer that
    runs whole on every rank: the backward takes this rank's chunk."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, \
            None, None


class _GatherSum(torch.autograd.Function):
    """The chunks on ``dim`` gathered over ``axes``, for a consumer split
    over them (each rank's gradient is partial): the backward sums and
    scatters (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, \
            None


# --------------------------------------------------------------- layout

@dataclass
class _Sharding:
    """What the stack needs of a model's mesh (``of``): on one device
    (``mesh`` None) every collective is the identity."""
    mesh: object = None
    specs: dict = dataclasses.field(default_factory=dict)
    M: int = 1            # size of the model axis (1 without one)
    r: int = 0            # this rank's index on it
    daxes: tuple = ()
    n_data: int = 1
    vocab_split: bool = False   # the embedding (or head) split over model

    @classmethod
    def of(cls, params):
        mesh = getattr(params, "mesh", None)
        if mesh is None:
            return cls()
        has_m = "model" in mesh.shape
        daxes = data_axes(mesh)
        head = "embed" if params.cfg.tie_embeddings else "lm_head"
        return cls(mesh, params.specs, mesh.shape["model"] if has_m else 1,
                   mesh.axis_index("model") if has_m else 0, daxes,
                   mesh.axis_size(daxes) if daxes else 1,
                   "model" in params.specs[head])

    def copy(self, x):
        """Identity; the gradient summed over ``model`` (the input of a
        region split over it)."""
        return _Copy.apply(x, self.mesh, "model") if self.M > 1 else x

    def reduce(self, x):
        """The sum over ``model`` of a split region's partial output."""
        return _Reduce.apply(x, self.mesh, "model") if self.M > 1 else x

    def gather_sum(self, x, dim):
        """The chunks on ``dim`` gathered over ``model`` for a consumer
        split over it (the backward reduce-scatters)."""
        return _GatherSum.apply(x, self.mesh, "model", dim) \
            if self.M > 1 else x

    def data_sum(self, t):
        """The sum of a detached value over the data axes."""
        return self.mesh.all_reduce(t, self.daxes) if self.n_data > 1 else t

    def kept(self, pre, names, p) -> bool:
        """Whether the rules' ``model`` split holds for every weight
        ``names`` of the block (none dropped by ``_sanitize``)."""
        return self.M > 1 and all(
            self.specs[pre + n] == _spec_for_name(
                pre + n, self._full(pre + n, p[n]), None)
            for n in names if n in p)

    def _full(self, name, t):
        return tuple(s * (self.M if e == "model" else 1)
                     for s, e in zip(t.shape, self.specs[name]))

    def gathered(self, p, pre) -> dict:
        """The block's weights, each gathered over ``model`` where its
        spec splits it (for a block that runs whole on every rank)."""
        if self.M == 1:
            return p
        out = {}
        for k, v in p.items():
            spec = self.specs[pre + k]
            dim = spec.index("model") if "model" in spec else None
            out[k] = v if dim is None else \
                _Gather.apply(v, self.mesh, "model", dim)
        return out


def vocab_split(params) -> bool:
    """Whether a sharded model's logits are split over the vocabulary on
    ``model``."""
    return _Sharding.of(params).vocab_split


def full_shapes(params) -> dict:
    """{name: global shape} of a sharded model's parameters."""
    mesh = params.mesh
    return {k: tuple(s * (mesh.axis_size(e) if e else 1)
                     for s, e in zip(p.shape, params.specs[k]))
            for k, p in params.named_parameters()}


# --------------------------------------------------------------- blocks

def _split_dim(local, full) -> int | None:
    """The dimension on which a cache or state leaf of shape ``local`` is
    this rank's chunk of ``full`` (split over ``model``), or None."""
    dims = [i for i, (a, b) in enumerate(zip(local, full)) if a != b]
    return dims[0] if dims else None


def _whole(tree, full: dict, sh: _Sharding):
    """A cache or state tree (``{"k", "v"}`` or ``{"h", "conv"}``) whole
    over ``model``: each leaf gathered on its split dimension. Returns
    (tree, {leaf: dim}) so ``_part`` can take this rank's chunks back."""
    out, dims = {}, {}
    for k, v in tree.items():
        d = _split_dim(v.shape, full[k]) if k in full else None
        dims[k] = d
        out[k] = v if d is None else sh.mesh.all_gather(v, "model", d)
    return out, dims


def _part(tree, dims: dict, sh: _Sharding):
    return {k: v if dims.get(k) is None else
            _chunk(v, sh.mesh, "model", dims[k]).contiguous()
            for k, v in tree.items()}


def attention_block(p, pre, x, cfg: ModelConfig, sh: _Sharding, *, kind,
                    ctx=None, mask_mode="causal", cache=None, pos_offset=0):
    """(out, new cache) of attention: over this rank's heads, or whole."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if sh.kept(pre, ("wq", "wk", "wv", "wo", "bq", "bk", "bv"), p) and \
            H % sh.M == 0 and KV % sh.M == 0:
        lcfg = dataclasses.replace(cfg, n_heads=H // sh.M,
                                   n_kv_heads=KV // sh.M, d_head=dh)
        out, new = attention(p, sh.copy(x), lcfg, kind=kind,
                             ctx=None if ctx is None else sh.copy(ctx),
                             mask_mode=mask_mode, cache=cache,
                             pos_offset=pos_offset)
        return sh.reduce(out), new
    dims = {}
    if cache is not None and sh.M > 1:
        B = x.shape[0]
        full = {k: (B, KV, cache[k].shape[2], dh) for k in ("k", "v")}
        cache, dims = _whole(cache, full, sh)
    out, new = attention(sh.gathered(p, pre), x, cfg, kind=kind, ctx=ctx,
                         mask_mode=mask_mode, cache=cache,
                         pos_offset=pos_offset)
    return out, None if new is None else _part(new, dims, sh)


def mlp_block(p, pre, x, cfg: ModelConfig, sh: _Sharding):
    if sh.kept(pre, ("w1", "w3", "w2"), p):
        return sh.reduce(mlp(p, sh.copy(x), cfg))
    return mlp(sh.gathered(p, pre), x, cfg)


def moe_block(p, pre, x, cfg: ModelConfig, sh: _Sharding):
    """The MoE layer on the data group's tokens; returns this rank's rows
    and the aux loss of the whole group's tokens."""
    xa = x
    if sh.n_data > 1:
        xa = _GatherSum.apply(x, sh.mesh, sh.daxes, 0)
    if sh.kept(pre, ("w1", "w3", "w2"), p):
        buf, route, aux = moe_dispatch(p, xa, cfg)
        loc = _Scatter.apply(buf, sh.mesh, "model", 1)
        y = _Gather.apply(moe_experts(loc, p["w1"], p["w3"], p["w2"]),
                          sh.mesh, "model", 1)
    else:
        w = sh.gathered(p, pre)
        buf, route, aux = moe_dispatch(w, xa, cfg)
        y = moe_experts(buf, w["w1"], w["w3"], w["w2"])
    out = moe_combine(y, route, xa.shape)
    if sh.n_data > 1:
        out = _chunk(out, sh.mesh, sh.daxes, 0)
    return out, aux


def recurrent_block(block, state_init, p, pre, x, cfg: ModelConfig,
                    sh: _Sharding, state=None):
    """A recurrent block (``ssm_block``, ``rglru_block``): split over
    ``model`` by its channels when the rules keep every weight's split
    (the block takes ``split=sh``), else run whole on every rank, its
    weights and state gathered over ``model`` (on one model rank, the
    block as it is). Returns (out, this rank's chunks of the new state);
    ``state_init`` gives the whole state's shapes."""
    if sh.kept(pre, tuple(p.keys()), p):
        return block(p, x, cfg, state=state, split=sh)
    dims = {}
    if state is not None and sh.M > 1:
        full = {k: tuple(v.shape) for k, v in
                state_init(cfg, x.shape[0], device="meta").items()}
        state, dims = _whole(state, full, sh)
    out, new = block(sh.gathered(p, pre), x, cfg, state=state)
    return out, None if new is None else _part(new, dims, sh)


def rows(t, B: int, sh: _Sharding):
    """This rank's rows of a per-slot tensor given for the whole batch (a
    cache's ``pos``, a decode position)."""
    if sh.n_data > 1 and t.ndim and t.shape[0] == B * sh.n_data:
        return _chunk(t, sh.mesh, sh.daxes, 0)
    return t


# ----------------------------------------------------------- boundaries

def seq_parallel(hook, sh: _Sharding, S: int) -> bool:
    """Whether the activations between layers are split over the
    sequence on ``model`` (a sequence-parallel hook, ``S`` divisible)."""
    return bool(getattr(hook, "sequence_parallel", False)) and sh.M > 1 \
        and S % sh.M == 0


def embed(emb, tokens, sh: _Sharding):
    """The embedding rows of ``tokens``: a masked lookup of this rank's
    vocabulary slice summed over ``model`` when the vocabulary is split."""
    if not sh.vocab_split:
        return emb[tokens]
    V = emb.shape[0]
    idx = tokens - sh.r * V
    inside = (idx >= 0) & (idx < V)
    return sh.reduce(emb[idx.clamp(0, V - 1)]
                     * inside[..., None].to(emb.dtype))


def log_likelihood(logits, labels, sh: _Sharding):
    """log p(label) of every position (a label below 0 reads class 0;
    the caller masks it): over this rank's vocabulary slice, the max, the
    sum of exponentials and the picked logit reduced over ``model``, when
    the vocabulary is split."""
    if not sh.vocab_split:
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    V = logits.shape[-1]
    m = sh.mesh.all_reduce(logits.detach().amax(-1), "model", op="max")
    se = sh.reduce(torch.exp(logits - m[..., None]).sum(-1))
    lab = labels.clamp_min(0) - sh.r * V
    inside = ((lab >= 0) & (lab < V)).to(logits.dtype)
    picked = sh.reduce(torch.gather(
        logits, -1, lab.clamp(0, V - 1)[..., None])[..., 0] * inside)
    return (picked - m) - torch.log(se)


# -------------------------------------------------------------- gathers

def gather_tree(flat: dict, specs: dict, mesh) -> dict:
    """Global tensors of ``flat`` ({name: this rank's shard}) under
    ``specs``: each sharded dimension gathered over its axes."""
    out = {}
    with torch.no_grad():
        for k, t in flat.items():
            for dim, e in enumerate(specs[k]):
                if e is not None:
                    t = mesh.all_gather(t, e, dim)
            out[k] = t
    return out


def gather_params(params) -> dict:
    """{name: global parameter} of a sharded model."""
    return gather_tree({k: p.detach() for k, p in params.named_parameters()},
                       params.specs, params.mesh)
