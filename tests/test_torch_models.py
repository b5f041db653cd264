"""The port's LM stack held to the JAX package's on the CPU: every config
field for field (and its parameter counts), ``input_specs`` and
``build_caches`` shapes and dtypes, the weight round trip (exact), each
block (``rmsnorm``, ``rope``, every form of ``attention``, ``mlp``,
``moe_mlp``, ``ssm_block``, ``rglru_block``) on the same inputs and
parameters, and ``forward_logits`` of all 10 smoke configs on the
reference's weights (reference ``init_model`` -> numpy ->
``load_reference_params``). In the port alone, decode reproduces the
full-sequence forward for all 10.

Tolerances: f32 throughout, ``ATOL`` and ``RTOL`` against the reference
(the two differ only in summation order and transcendental rounding);
``DECODE_TOL`` for decode against forward in the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import config as r_config  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import rglru as r_rglru  # noqa: E402
from repro.models import ssm as r_ssm  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import config, layers, moe, rglru, ssm  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    load_reference_params, to_reference_params)
from repro_torch.models.model import (  # noqa: E402
    build_caches, forward_logits, init_model, run_encoder, set_cache_pos)

ATOL = RTOL = 2e-5
DECODE_TOL = 1e-4
ARCHS = list(r_configs.ARCHS)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _tree_close(got, want, atol=ATOL):
    """Two nested dicts of arrays with the same keys, leaf by leaf."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], atol)
        else:
            _close(got[k], want[k], atol=atol)


def _params(rng, shapes):
    """Random f32 parameters: a dict of numpy arrays by name."""
    return {k: (rng.normal(size=s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in p.items()})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(moe=None, ssm=None, **kw):
    """A small config in the reference's classes and the port's; ``moe``
    and ``ssm`` are dicts of their configs' fields."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_head=8, d_ff=48, vocab=64)
    base.update(kw)
    out = []
    for mod in (r_config, config):
        sub = {}
        if moe is not None:
            sub["moe"] = mod.MoEConfig(**moe)
        if ssm is not None:
            sub["ssm"] = mod.SSMConfig(**ssm)
        out.append(mod.ModelConfig(**base, **sub))
    return tuple(out)


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        want = r_configs.get_config(arch, smoke=smoke)
        got = configs.get_config(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert got.layer_kinds() == want.layer_kinds()
        assert got.tail_kinds == want.tail_kinds
    assert list(configs.ARCHS) == ARCHS
    assert configs.SHAPES == r_configs.SHAPES


def _spec_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("shape", list(r_configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    cfg, rcfg = configs.get_config(arch), r_configs.get_config(arch)
    assert configs.shape_skip_reason(cfg, shape) == \
        r_configs.shape_skip_reason(rcfg, shape)
    got = configs.input_specs(cfg, shape)
    want = r_configs.input_specs(rcfg, shape)
    assert _spec_leaves(got) == _spec_leaves(want)
    assert all(t.device.type == "meta"
               for t in jax.tree.leaves(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_build_caches_match_reference(arch):
    cfg = configs.get_config(arch, smoke=True)
    rcfg = r_configs.get_config(arch, smoke=True)
    got = build_caches(cfg, 3, 20, dtype=torch.float32, device="cpu")
    want = r_model.build_caches(rcfg, 3, 20, dtype=jnp.float32)
    assert _spec_leaves(got) == _spec_leaves(want)
    pos = set_cache_pos(got, 7)
    for path, leaf in _spec_leaves(pos).items():
        if path.endswith("/pos"):
            assert leaf[1] == "int32"


# ----------------------------------------------------------------- weights

@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke parameters, as numpy trees, by arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = r_configs.get_config(arch, smoke=True)
            cache[arch] = _np_tree(r_model.init_model(
                jax.random.PRNGKey(0), rcfg, dtype=jnp.float32))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_round_trip_is_exact(arch, ref_params):
    cfg = configs.get_config(arch, smoke=True)
    tree = ref_params(arch)
    model = load_reference_params(cfg, tree, device="cpu")
    back = to_reference_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    # the port's own init has the reference's tree, shapes and dtypes
    own = to_reference_params(init_model(0, cfg, device="cpu"))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), own) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), tree)


def test_bf16_round_trip_and_dtype_rule():
    cfg = configs.get_config("recurrentgemma-2b", smoke=True)
    rcfg = r_configs.get_config("recurrentgemma-2b", smoke=True)
    tree = _np_tree(r_model.init_model(jax.random.PRNGKey(1), rcfg,
                                       dtype=jnp.bfloat16))
    model = load_reference_params(cfg, tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert model.layers[0]["ln1"]["w"].dtype == torch.float32
    back = to_reference_params(model)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a.view(np.uint16) if a.dtype.itemsize == 2 else a,
        b.view(np.uint16) if b.dtype.itemsize == 2 else b), back, tree)
    own = to_reference_params(init_model(0, cfg, torch.bfloat16,
                                         device="cpu"))
    assert jax.tree.map(lambda a: a.dtype.name, own) == \
        jax.tree.map(lambda a: a.dtype.name, tree)


# ----------------------------------------------------------------- blocks

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(layers.rmsnorm({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                          1e-6),
           r_layers.rmsnorm({"w": jnp.asarray(w)}, jnp.asarray(x), 1e-6))
    shared = np.arange(5) + 3
    per_slot = np.stack([np.arange(5) + 7, np.arange(5) + 100])
    for pos in (shared, per_slot):
        _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                           10000.0),
               r_layers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def _attn_params(rng, cfg, bias=False):
    d, dh, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, H * dh), "wk": (d, KV * dh), "wv": (d, KV * dh),
              "wo": (H * dh, d)}
    if bias:
        shapes.update(bq=(H * dh,), bk=(KV * dh,), bv=(KV * dh,))
    return _both(_params(rng, shapes))


ATTN_FORMS = {
    "full": ({}, "attn", 0),
    "local": ({"local_window": 5}, "local", 0),
    "softcap_offset": ({"attn_softcap": 5.0}, "attn", 3),
    "gqa_4_over_1": ({"n_kv_heads": 1}, "attn", 0),
    "qkv_bias": ({"qkv_bias": True}, "attn", 0),
    "chunked_causal": ({"attn_q_chunk": 4}, "attn", 0),
    "chunked_local_softcap": ({"attn_q_chunk": 4, "local_window": 6,
                               "attn_softcap": 3.0}, "local", 0),
}


@pytest.mark.parametrize("form", list(ATTN_FORMS))
def test_attention_forms(form):
    kw, kind, offset = ATTN_FORMS[form]
    rcfg, cfg = _cfg(**kw)
    rng = np.random.default_rng(1)
    rp, tp = _attn_params(rng, cfg, bias=cfg.qkv_bias)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    want, _ = r_layers.attention(rp, jnp.asarray(x), rcfg, kind=kind,
                                 pos_offset=offset)
    got, cache = layers.attention(tp, torch.from_numpy(x), cfg, kind=kind,
                                  pos_offset=offset)
    assert cache is None
    _close(got, want)


def test_attention_cross_and_bidir():
    rcfg, cfg = _cfg()
    rng = np.random.default_rng(2)
    rp, tp = _attn_params(rng, cfg)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    ctx = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    want, _ = r_layers.attention(rp, jnp.asarray(x), rcfg, kind="attn",
                                 ctx=jnp.asarray(ctx))
    got, _ = layers.attention(tp, torch.from_numpy(x), cfg, kind="attn",
                              ctx=torch.from_numpy(ctx))
    _close(got, want)
    want, _ = r_layers.attention(rp, jnp.asarray(x), rcfg, kind="attn",
                                 mask_mode="bidir")
    got, _ = layers.attention(tp, torch.from_numpy(x), cfg, kind="attn",
                              mask_mode="bidir")
    _close(got, want)


@pytest.mark.parametrize("kind", ["local", "attn"])
def test_attention_decode_ring_buffer(kind):
    """Three decode steps at per-slot positions past the window: local
    layers write slot pos % C of the ring, full ones clip(pos, 0, C-1)."""
    rcfg, cfg = _cfg(local_window=6, attn_softcap=4.0)
    rng = np.random.default_rng(3)
    rp, tp = _attn_params(rng, cfg)
    C = 6
    kv = rng.normal(size=(2, 2, 2, C, cfg.head_dim)).astype(np.float32)
    pos = np.array([4, 11], np.int32)
    rc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
          "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1]),
          "pos": torch.from_numpy(pos)}
    for step in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        p = pos + step
        want, rc = r_layers.attention(rp, jnp.asarray(x), rcfg, kind=kind,
                                      pos_offset=jnp.asarray(p),
                                      cache=dict(rc, pos=jnp.asarray(p)))
        got, tc = layers.attention(tp, torch.from_numpy(x), cfg, kind=kind,
                                   pos_offset=torch.from_numpy(p),
                                   cache=dict(tc, pos=torch.from_numpy(p)))
        _close(got, want)
        _tree_close(tc, dict(rc))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    rcfg, cfg = _cfg(act=act)
    rng = np.random.default_rng(4)
    d, f = cfg.d_model, cfg.d_ff
    shapes = {"w1": (d, f), "w2": (f, d)}
    if act != "gelu":
        shapes["w3"] = (d, f)
    rp, tp = _both(_params(rng, shapes))
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    _close(layers.mlp(tp, torch.from_numpy(x), cfg),
           r_layers.mlp(rp, jnp.asarray(x), rcfg))


@pytest.mark.parametrize("groups,capacity", [(1, 0.5), (2, 0.5), (2, 64.0)])
def test_moe_mlp(groups, capacity):
    """Drops (capacity factor 0.5) with one and two dispatch groups, and
    the drop-free case."""
    base = r_configs.get_config("granite-moe-1b-a400m", smoke=True).moe
    rcfg, cfg = _cfg(moe=dict(dataclasses.asdict(base),
                              capacity_factor=capacity,
                              dispatch_groups=groups))
    rng = np.random.default_rng(5)
    mcfg = cfg.moe
    d, f, E = cfg.d_model, mcfg.d_ff_expert, mcfg.num_experts
    p = _params(rng, {"router": (d, E), "w1": (E, d, f), "w3": (E, d, f),
                      "w2": (E, f, d)})
    p["router"] *= 10.0          # peaked routing, so experts overflow
    rp, tp = _both(p)
    x = rng.normal(size=(2, 48, d)).astype(np.float32)
    want, want_aux = r_moe.moe_mlp(rp, jnp.asarray(x), rcfg)
    got, aux = moe.moe_mlp(tp, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, want_aux)
    assert moe.moe_capacity(cfg, 32) == r_moe.moe_capacity(rcfg, 32)
    if capacity < 1:
        free = dataclasses.replace(cfg, moe=dataclasses.replace(
            mcfg, capacity_factor=64.0))
        full, _ = moe.moe_mlp(tp, torch.from_numpy(x), free)
        assert not torch.allclose(full, got), "no assignment was dropped"


def _ssm_case(rng):
    rcfg, cfg = _cfg(block_pattern=("ssm",), ssm=dataclasses.asdict(
        r_configs.get_config("falcon-mamba-7b", smoke=True).ssm))
    p = _np_tree(r_ssm.ssm_init(jax.random.PRNGKey(6), rcfg))
    p["dt_bias"] = (rng.normal(size=p["dt_bias"].shape) - 1).astype(
        np.float32)
    st = {"h": rng.normal(size=(2, 2 * cfg.d_model, cfg.ssm.d_state)),
          "conv": rng.normal(size=(2, cfg.ssm.d_conv - 1, 2 * cfg.d_model))}
    return rcfg, cfg, p, r_ssm.ssm_block, ssm.ssm_block, st


def _rglru_case(rng):
    rcfg, cfg = _cfg(block_pattern=("rglru",))
    p = _np_tree(r_rglru.rglru_init(jax.random.PRNGKey(7), rcfg))
    p["lam"] = rng.normal(size=p["lam"].shape).astype(np.float32)
    st = {"h": rng.normal(size=(2, cfg.d_model)),
          "conv": rng.normal(size=(2, 3, cfg.d_model))}
    return rcfg, cfg, p, r_rglru.rglru_block, rglru.rglru_block, st


@pytest.mark.parametrize("case", [_ssm_case, _rglru_case],
                         ids=["ssm", "rglru"])
def test_recurrent_blocks_full_and_step(case):
    rng = np.random.default_rng(8)
    rcfg, cfg, p, ref_block, port_block, st = case(rng)
    rp, tp = _both(p)
    x = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
    want, _ = ref_block(rp, jnp.asarray(x), rcfg)
    got, none = port_block(tp, torch.from_numpy(x), cfg)
    assert none is None
    _close(got, want)
    st = {k: v.astype(np.float32) for k, v in st.items()}
    rs, ts = _both(st)
    for t in range(3):
        xt = x[:, t: t + 1]
        want, rs = ref_block(rp, jnp.asarray(xt), rcfg, state=rs)
        got, ts = port_block(tp, torch.from_numpy(xt), cfg, state=ts)
        _close(got, want)
        _tree_close(ts, rs)


def test_linear_scan_matches_a_loop():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 37, 4)))
    u = torch.from_numpy(rng.normal(size=(3, 37, 4)))
    h, want = torch.zeros(3, 4, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + u[:, t]
        want.append(h)
    torch.testing.assert_close(ssm.linear_scan(a, u), torch.stack(want, 1),
                               atol=1e-12, rtol=1e-12)


# ----------------------------------------------------------------- the model

def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = (rng.normal(size=(B, cfg.encoder.n_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    elif cfg.n_patch_tokens:
        extra["patches"] = (rng.normal(size=(B, cfg.n_patch_tokens,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    return toks, extra


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_reference(arch, ref_params):
    cfg = configs.get_config(arch, smoke=True)
    rcfg = r_configs.get_config(arch, smoke=True)
    tree = ref_params(arch)
    model = load_reference_params(cfg, tree, device="cpu")
    toks, extra = _inputs(cfg)
    rp = jax.tree.map(jnp.asarray, tree)
    r_ctx = ctx = None
    if "frames" in extra:
        r_ctx = r_model.run_encoder(rp, jnp.asarray(extra["frames"]), rcfg)
        with torch.no_grad():
            ctx = run_encoder(model, torch.from_numpy(extra["frames"]), cfg)
        _close(ctx, r_ctx)
    elif "patches" in extra:
        r_ctx, ctx = jnp.asarray(extra["patches"]), \
            torch.from_numpy(extra["patches"])
    want, _, want_aux = r_model.forward_logits(rp, jnp.asarray(toks), rcfg,
                                               ctx=r_ctx)
    with torch.no_grad():
        got, none, aux = forward_logits(model, toks, cfg, ctx=ctx)
    assert none is None and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Per-token decode with caches reproduces the full-sequence forward
    (capacity raised for MoE, as the reference's test does: full-sequence
    routing drops under contention, single-token decode never)."""
    cfg = configs.get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    model = init_model(2, cfg, device="cpu")
    B, S = 2, 12
    toks, extra = _inputs(cfg, B, S, seed=2)
    with torch.no_grad():
        ctx = None
        if "frames" in extra:
            ctx = run_encoder(model, torch.from_numpy(extra["frames"]), cfg)
        elif "patches" in extra:
            ctx = torch.from_numpy(extra["patches"])
        full, _, _ = forward_logits(model, toks, cfg, ctx=ctx)
        caches = build_caches(cfg, B, S, dtype=torch.float32, device="cpu")
        outs = []
        for t in range(S):
            caches = set_cache_pos(caches, t)
            logits, caches, _ = forward_logits(
                model, toks[:, t: t + 1], cfg, ctx=ctx, caches=caches,
                pos_offset=torch.tensor(t, dtype=torch.int32))
            outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=DECODE_TOL,
                               rtol=DECODE_TOL)


def test_init_model_draws_from_its_seed():
    cfg = configs.get_config("smollm-135m", smoke=True)
    a = init_model(5, cfg, device="cpu")
    b = init_model(5, cfg, device="cpu")
    c = init_model(6, cfg, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.ndim >= 2:
            assert not torch.equal(pa, pc), name
    assert len(a.layers) == cfg.n_layers
