"""The port's training step held to the JAX package's on the CPU, on the
reference's weights (reference ``init_model`` -> numpy ->
``load_reference_params``): ``loss_fn``'s loss, xent and aux and every
gradient leaf of all 10 smoke configs against ``jax.value_and_grad`` of
the reference's ``loss_fn`` (gradients compared in the reference's layout,
restacked by ``convert``); one ``make_train_step`` step, plain and
microbatched, against the reference's jitted step; padding labels (-1);
the four remat policies agree in the port and an unknown one raises; the
sharded knobs raise naming ROADMAP A11c; the entry points refuse to run
without a card unless asked for the CPU.

Tolerances (f32; the two differ in summation order and transcendental
rounding): the loss, xent, aux and ``grad_norm`` within ``LOSS_RTOL``;
every gradient leaf within ``GRAD_ATOL`` / ``GRAD_RTOL``; parameters after
a step within ``2.5 * lr``: AdamW's first step moves each weight by about
``lr`` along the sign of its gradient, so a gradient near 0 may flip it
(the reference's own sharded test allows 5e-3 at lr 1e-3); the moments
within ``GRAD_ATOL`` / ``GRAD_RTOL`` times their (1 - b) factors.
"""
import functools
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import train as r_train  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import train  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    _reference_tree, load_reference_opt_state,
    load_reference_params, to_reference_opt_state, to_reference_params)
from repro_torch.models.model import forward_logits, init_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_from_paths  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

ARCHS = list(r_configs.ARCHS)
LOSS_RTOL = 1e-5
GRAD_ATOL = 2e-6
GRAD_RTOL = 1e-4
LR = 1e-3
#: the configs whose whole step is held to the reference's jitted step:
#: local and global attention with both softcaps, and an MoE with its aux
STEP_ARCHS = ("gemma2-2b", "granite-moe-1b-a400m")


def _batch(cfg, B=2, S=16, seed=0, pad=False):
    """A batch as the reference's ``tests/test_arch_smoke.py`` draws it
    (numpy); ``pad`` sets some labels, and a whole row, to -1."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = (rng.normal(size=(B, cfg.encoder.n_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    elif cfg.n_patch_tokens:
        batch["patches"] = (rng.normal(size=(B, cfg.n_patch_tokens,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    if pad:
        batch["labels"][0, S // 2:] = -1
        batch["labels"][1, ::3] = -1
    return batch


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _fresh_opt(model):
    return adamw_init(dict(model.named_parameters()))


def _reference_grads(arch, batch, seed=0):
    """(numpy params, loss, metrics, numpy grads) of the reference."""
    rcfg = r_configs.get_config(arch, smoke=True)
    params = r_model.init_model(jax.random.PRNGKey(seed), rcfg,
                                dtype=jnp.float32)
    fn = jax.jit(jax.value_and_grad(
        functools.partial(r_train.loss_fn, cfg=rcfg), has_aux=True))
    (loss, metrics), grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return (_np_tree(params), float(loss),
            {k: float(v) for k, v in metrics.items()}, _np_tree(grads))


@pytest.fixture(scope="module")
def reference():
    """arch -> the reference's params, loss, metrics and grads on
    ``_batch(cfg)``, computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_config(arch, smoke=True)
            batch = _batch(cfg)
            cache[arch] = (batch,) + _reference_grads(arch, batch)
        return cache[arch]
    return get


def _port_grads(model, batch, cfg, policy="dots"):
    """(loss, metrics, grads in the reference's layout as numpy)."""
    loss, metrics = train.loss_fn(model, batch, cfg,
                                  remat_policy=train.REMAT_POLICIES[policy])
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            _reference_tree(cfg, tree_from_paths(dict(zip(names, grads)), ".")))


def _close_trees(got, want, atol, rtol, what):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(
            g, flat_want[path], atol=atol, rtol=rtol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, reference):
    batch, r_params, r_loss, r_metrics, r_grads = reference(arch)
    cfg = get_config(arch, smoke=True)
    model = load_reference_params(cfg, r_params, device="cpu")
    loss, metrics, grads = _port_grads(model, batch, cfg)
    np.testing.assert_allclose(loss, r_loss, rtol=LOSS_RTOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(metrics[k], r_metrics[k], rtol=LOSS_RTOL,
                                   atol=1e-7)
    _close_trees(grads, r_grads, GRAD_ATOL, GRAD_RTOL, f"{arch} grad")


def test_padding_labels_match_reference():
    arch = "smollm-135m"
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg, seed=4, pad=True)
    r_params, r_loss, r_metrics, r_grads = _reference_grads(arch, batch)
    model = load_reference_params(cfg, r_params, device="cpu")
    loss, metrics, grads = _port_grads(model, batch, cfg)
    np.testing.assert_allclose(loss, r_loss, rtol=LOSS_RTOL)
    _close_trees(grads, r_grads, GRAD_ATOL, GRAD_RTOL, "padded grad")
    # every label padding: the divisor is 1, the loss the aux alone
    batch["labels"][:] = -1
    loss, metrics, _ = _port_grads(model, batch, cfg)
    assert loss == metrics["xent"] + metrics["aux"] and metrics["xent"] == 0


@pytest.mark.parametrize("microbatch", [None, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch, microbatch, reference):
    batch, r_params, _, _, _ = reference(arch)
    rcfg = r_configs.get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    r_step = jax.jit(r_train.make_train_step(rcfg, lr=LR,
                                             microbatch=microbatch))
    jp = jax.tree.map(jnp.asarray, r_params)
    r_new, r_opt, r_metrics = r_step(jp, r_adamw.adamw_init(jp),
                                     jax.tree.map(jnp.asarray, batch))
    model = load_reference_params(cfg, r_params, device="cpu")
    step = train.make_train_step(cfg, lr=LR, microbatch=microbatch,
                                 device="cpu")
    new, opt, metrics = step(model, _fresh_opt(model), batch)
    assert new is model
    assert set(metrics) == {"xent", "aux", "loss", "grad_norm"}
    for k, v in metrics.items():
        assert v.shape == () and v.dtype == torch.float32
        np.testing.assert_allclose(float(v), float(r_metrics[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    _close_trees(to_reference_params(new), _np_tree(r_new), 2.5 * LR, 0,
                 f"{arch} params")
    got_opt = to_reference_opt_state(cfg, opt)
    assert int(got_opt["step"]) == int(r_opt["step"]) == 1
    for k, b in (("m", 0.1), ("v", 0.05)):
        scale = b * float(r_metrics["grad_norm"]) ** (2 if k == "v" else 1)
        _close_trees(got_opt[k], _np_tree(r_opt[k]), GRAD_ATOL * scale,
                     GRAD_RTOL * (2 if k == "v" else 1), f"{arch} {k}")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small"])
def test_remat_policies_agree(arch):
    """The policy changes what the backward pass keeps, not the numbers:
    recurrentgemma-2b has a tail layer past its cycle, whisper-small an
    encoder."""
    cfg = get_config(arch, smoke=True)
    model = init_model(3, cfg, device="cpu")
    batch = _batch(cfg, seed=5)
    want = _port_grads(model, batch, cfg, policy=None)
    for policy in ("none", "dots", "nothing", "everything"):
        got = _port_grads(model, batch, cfg, policy=policy)
        assert got[0] == want[0] and got[1] == want[1], policy
        _close_trees(got[2], want[2], 0, 0, f"{policy} grad")
    with pytest.raises(KeyError):
        train.make_train_step(cfg, remat_policy="dots_saveable",
                              device="cpu")


class _Made(TorchDispatchMode):
    """Records (weak reference, bytes) of every storage an op makes."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.made.setdefault(s._cdata, (StorageWeakRef(s),
                                                s.nbytes()))
        return out

    def alive(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.made.values() if not ref.expired())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_keep_less_for_the_backward(arch):
    """The bytes the forward leaves alive for the backward (what it made
    and still holds when ``loss_fn`` returns): ``"nothing"`` keeps only
    the cycles' inputs and the tail, ``"dots"`` adds the matmul outputs,
    ``"none"`` and ``"everything"`` keep all."""
    cfg = get_config(arch, smoke=True)
    model = init_model(3, cfg, device="cpu")
    batch = _batch(cfg, seed=5)
    kept = {}
    for policy in ("none", "everything", "dots", "nothing"):
        mode = _Made()
        with mode:
            loss, _ = train.loss_fn(
                model, batch, cfg, remat_policy=train.REMAT_POLICIES[policy])
        kept[policy] = mode.alive()
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        assert all(g is None or torch.isfinite(g).all() for g in grads)
    assert kept["nothing"] < kept["dots"] < kept["none"] == \
        kept["everything"], kept


class _Shapes(TorchDispatchMode):
    """Records (weak reference, the shapes of the op outputs on it) of
    every storage an op makes."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.made.setdefault(s._cdata, (StorageWeakRef(s), set()))[
                    1].add(tuple(t.shape))
        return out

    def alive(self) -> set:
        gc.collect()
        return set().union(*(shapes for ref, shapes in self.made.values()
                             if not ref.expired()))


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-1b-a400m"])
def test_dots_policy_recomputes_the_batched_matmuls(arch):
    """ROADMAP C10: ``"dots"`` is the reference's
    ``dots_with_no_batch_dims_saveable``: the outputs of the batched
    matmuls (``bmm``), the attention scores [B, KV, G, S, T] and the MoE
    experts' [G, E, C, D], are recomputed, so no tensor the forward
    leaves for the backward has their shape; the
    projections (``mm``) are saved. The outer ``saved_tensors_hooks``
    see only what is saved outside a checkpointed cycle (the checkpoint's
    own hooks take what is saved inside it), so the storages still alive
    after the forward are what it keeps, as in
    ``test_remat_policies_keep_less_for_the_backward``."""
    from repro_torch.models.moe import moe_capacity
    cfg = get_config(arch, smoke=True)
    model = init_model(3, cfg, device="cpu")
    batch = _batch(cfg, seed=5)
    B, S = batch["tokens"].shape
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    batched = {(B, KV, G, S, S)}
    if cfg.moe is not None:
        batched.add((1, cfg.moe.num_experts, moe_capacity(cfg, B * S),
                     cfg.d_model))
    kept, outside = {}, {}
    for policy in ("none", "dots"):
        seen = outside[policy] = set()

        def pack(t):
            seen.add(tuple(t.shape))
            return t
        mode = _Shapes()
        with mode, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = train.loss_fn(
                model, batch, cfg, remat_policy=train.REMAT_POLICIES[policy])
        kept[policy] = mode.alive()
        del loss
    # the shapes are the right ones: without checkpointing they are saved
    assert batched <= kept["none"] and batched <= outside["none"]
    assert not batched & kept["dots"], batched & kept["dots"]
    assert not batched & outside["dots"]
    # the projections' outputs stay saved under "dots"
    assert (B * S, cfg.n_heads * dh) in kept["dots"]


def test_activation_hook_sees_every_boundary():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    model = init_model(0, cfg, device="cpu")
    seen = []

    def hook(x, where):
        seen.append(where)
        return x * 2 if where == "final" else x
    toks = np.zeros((1, 4), np.int32)
    with torch.no_grad():
        plain = forward_logits(model, toks, cfg)[0]
        hooked = forward_logits(model, toks, cfg, activation_hook=hook,
                                unroll=True)[0]
    assert seen == ["embed"] + ["layer"] * cfg.n_layers + ["final", "logits"]
    assert not torch.equal(plain, hooked)


def test_sharded_knobs_name_their_roadmap_item():
    """The sharded knobs (ROADMAP A11c) work: on a mesh of one rank
    ``make_train_step(grad_shardings=...)`` gives the plain step's numbers
    and ``train_loop(mesh=...)`` the plain run's losses. More ranks are
    ``tests/test_torch_sharding.py``'s."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.sharding import (
        distribute_model, named_sharding_tree, opt_state_specs)
    from repro_torch.runtime.elastic import remesh_tree
    cfg = get_config("smollm-135m", smoke=True)
    mesh = Mesh(np.zeros((1, 1), np.int64), ("data", "model"), device="cpu")
    batch = _batch(cfg)
    plain = init_model(3, cfg, device="cpu")
    _, _, want = train.make_train_step(cfg, lr=LR, device="cpu")(
        plain, _fresh_opt(plain), batch)
    model = init_model(3, cfg, device="cpu")
    specs = opt_state_specs(model, mesh)
    step = train.make_train_step(
        cfg, lr=LR, device="cpu",
        grad_shardings=named_sharding_tree(mesh, specs["m"]))
    fresh = _fresh_opt(model)
    opt = {k: remesh_tree(fresh[k], mesh, specs[k]) for k in ("m", "v")}
    sharded, _, got = step(distribute_model(model, mesh),
                           dict(opt, step=fresh["step"]), batch)
    for k in ("loss", "xent", "aux", "grad_norm"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=LOSS_RTOL)
    for k, p in plain.named_parameters():
        torch.testing.assert_close(dict(sharded.named_parameters())[k], p)
    run = dict(steps=3, batch=2, seq=16, device="cpu")
    assert train_loop("smollm-135m", mesh=mesh, **run)[2] == pytest.approx(
        train_loop("smollm-135m", **run)[2], rel=LOSS_RTOL)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m", smoke=True)
    model = init_model(0, cfg, device="cpu")
    opt = to_reference_opt_state(cfg, _fresh_opt(model))
    for call in (lambda: train.make_train_step(cfg),
                 lambda: train_loop("smollm-135m", steps=1),
                 lambda: load_reference_opt_state(cfg, opt)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    step = train.make_train_step(cfg, device="cpu")
    _, _, metrics = step(model, _fresh_opt(model), _batch(cfg))
    assert metrics["loss"].device.type == "cpu"
