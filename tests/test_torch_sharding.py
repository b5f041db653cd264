"""The port's sharded LM step held to the JAX package's on the CPU.

Specs: ``param_specs``, ``opt_state_specs`` and ``cache_specs`` of all 10
configurations at full width (shapes only: the port's model on ``meta``,
the reference's trees from ``jax.eval_shape``, its specs on an
``AbstractMesh``) on the meshes 16 x 16, 2 x 16 x 16, 4 x 2, 2 x 2 and
1 x 2, leaf for leaf through ``convert``'s name correspondence (layer
``c * period + i`` is the reference's ``cycle/p{i}`` without its stacked
dimension). Where the reference's ZeRO-1 rule puts the data axes on that
stacked dimension, which a layer's own tensor does not have, the port's
moment spec is the reference's rule applied to the layer's own leaf.

The sharded step, in gloo ranks (child processes over a ``FileStore``,
each under a timeout): gemma2-2b smoke at 8 x 32, lr 1e-3, on 2 x 2,
1 x 2 and 2 x 1 meshes, and granite-moe smoke on 1 x 2 (expert
parallel), each against the reference's jitted single-device step from
the same weights: the loss within 1e-4 and every parameter within 5e-3
(the bounds of the reference's ``tests/test_model_distributed.py``, whose
own run cannot go in this image), the grad norm within 1e-5 relative,
and every first moment (0.1 g after one step, gathered), leaf by leaf,
within 1e-4 of its largest entry: after one AdamW step every weight moves
by about lr whatever its gradient, so the parameter bound alone would
pass a gradient shard on the wrong rank or slice; the moments do not.
``train_loop(mesh=...)`` crashed on 2 x 2 and resumed on 2 x 1 from the
survivors gives the uninterrupted run's losses within rtol 1e-4 / atol
1e-5; the reference's ``test_elastic_remesh_subprocess`` scenario runs
with 8 ranks, then 4.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import sharding as r_sharding  # noqa: E402
from repro.models.train import make_train_step as r_make_step  # noqa: E402
from repro.optim.adamw import adamw_init as r_adamw_init  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.model import build_caches, init_model  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list(r_configs.ARCHS)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 2), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
LOSS_ATOL = 1e-4
PARAM_ATOL = 5e-3
M_TOL = 1e-4
NORM_RTOL = 1e-5
RESUME_TOL = dict(rtol=1e-4, atol=1e-5)
RANK_TIMEOUT = 240


# ------------------------------------------------------------------ specs

_CACHE: dict = {}


def _shapes(arch):
    """(port model on meta, reference param shapes, port caches on meta,
    reference cache shapes) of the full-width config, made once."""
    if arch not in _CACHE:
        rcfg = r_configs.get_config(arch)
        ref = jax.eval_shape(lambda: r_model.init_model(
            jax.random.PRNGKey(0), rcfg, dtype=jnp.float32))
        rcache = jax.eval_shape(lambda: r_model.build_caches(
            rcfg, 128, 32768, dtype=jnp.bfloat16))
        cfg = get_config(arch)
        _CACHE[arch] = (init_model(0, cfg, device="meta"), ref,
                        build_caches(cfg, 128, 32768, device="meta"), rcache)
    return _CACHE[arch]


def _flat(tree):
    return {tuple(getattr(k, "key", k) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _port_names(cfg, path):
    """The port's parameter names of a reference path and whether the
    reference's leaf is stacked (so its spec has a leading entry)."""
    period, n_cyc = cfg.pattern_period, cfg.n_cycles
    rest = ".".join(path[2:])
    if path[0] == "cycle":
        pi = int(path[1][1:])
        return [f"layers.{c * period + pi}.{rest}" for c in range(n_cyc)], True
    if path[0] == "tail":
        return [f"layers.{n_cyc * period + int(path[1][1:])}.{rest}"], False
    if path[:2] == ("encoder", "layers"):
        return [f"encoder.layers.{j}.{'.'.join(path[2:])}"
                for j in range(cfg.encoder.n_layers)], True
    return [".".join(path)], False


def _as_port(cfg, ref_specs):
    """The reference's spec tree by the port's names, stacked entries
    dropped: {name: (spec, the stacked entry or None)}."""
    out = {}
    for path, spec in _flat(ref_specs).items():
        names, stacked = _port_names(cfg, path)
        for n in names:
            out[n] = (spec[1:], spec[0]) if stacked else (spec, None)
    return out


def _abstract(shape, axes):
    return AbstractMesh(shape, axes), Mesh(np.arange(int(np.prod(shape)))
                                           .reshape(shape), axes,
                                           device="meta")


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, mesh_i):
    model, ref, _, _ = _shapes(arch)
    cfg = model.cfg
    rmesh, mesh = _abstract(*MESHES[mesh_i])
    want = _as_port(cfg, r_sharding.param_specs(ref, rmesh))
    got = sharding.param_specs(model, mesh)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        assert spec == want[name][0], name
        assert want[name][1] in (None,), name

    want_o = r_sharding.opt_state_specs(ref, rmesh)
    got_o = sharding.opt_state_specs(model, mesh)
    assert tuple(want_o["step"]) == got_o["step"] == ()
    # the reference's rule on each of the port's own (unstacked) leaves:
    # its tree by the port's names, "layers" renamed so nothing stacks
    own: dict = {}
    for k, p in model.named_parameters():
        *path, last = k.replace("layers.", "L.").split(".")
        node = own
        for part in path:
            node = node.setdefault(part, {})
        node[last] = jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
    flat_own = {".".join(path).replace("L.", "layers."): spec for path, spec
                in _flat(r_sharding.opt_state_specs(own, rmesh)["m"]).items()}
    moved = 0
    for k in ("m", "v"):
        want_k = _as_port(cfg, want_o[k])
        assert sorted(got_o[k]) == sorted(want_k)
        for name, spec in got_o[k].items():
            rest, lead = want_k[name]
            if lead is None:
                assert spec == rest, (k, name)
            else:
                # the reference split the stacked layers over the data axes
                moved += 1
                assert spec == flat_own[name], (k, name)
    if mesh.axis_size(sharding.data_axes(mesh)) == 1:
        assert got_o["m"] == got
        assert moved == 0


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_i):
    _, _, caches, rcache = _shapes(arch)
    rmesh, mesh = _abstract(*MESHES[mesh_i])
    want = _flat(r_sharding.cache_specs(rcache, rmesh))
    got = dict(sharding._leaves(sharding.cache_specs(caches, mesh)))
    assert got == want


def test_production_mesh_and_hook():
    mesh = make_production_mesh(multi_pod=True, device="meta")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.abstract and sharding.data_axes(mesh) == ("pod", "data")
    with pytest.raises(RuntimeError, match="only carries shapes"):
        mesh.all_reduce(torch.zeros(2), "model")
    hook = sharding.make_activation_hook(mesh)
    assert hook.sequence_parallel
    assert not sharding.make_activation_hook(mesh, decode=True) \
        .sequence_parallel
    # a flag the stack reads, not a function it calls
    assert not callable(hook)


def test_mesh_needs_a_card_unless_given_a_device(monkeypatch):
    """A mesh computes where every entry point does: ``device=None`` is
    the card, and without one it raises rather than run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Mesh(np.zeros((1, 1), np.int64), ("data", "model")),
                 lambda: make_production_mesh(),
                 lambda: make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Mesh(np.zeros((1, 1), np.int64), ("data", "model"),
                device="cpu").device == torch.device("cpu")


def test_local_shards_tile_the_array():
    a = np.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    blocks = {}
    for r in range(8):
        m = Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "data", "model"),
                 rank=r, device="meta")
        blocks[(m.axis_index(("pod", "data")), m.axis_index("model"))] = \
            sharding.local_shard(a, m, spec)
    got = np.block([[blocks[(i, j)] for j in range(2)] for i in range(4)])
    np.testing.assert_array_equal(got, a)


# ----------------------------------------------------------- gloo ranks

def _start_ranks(tmp: Path, n: int, body: str, tag: str,
                 args: tuple = ()) -> list:
    """``body`` started in ``n`` gloo ranks (child processes over a
    ``FileStore``); ``_finish_ranks`` collects them."""
    code = textwrap.dedent("""
        import json, sys
        import numpy as np
        import torch
        import torch.distributed as dist
        rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        args = sys.argv[4:]
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
    """) + textwrap.dedent(body) + textwrap.dedent("""
        # no rank tears the group down under another
        dist.barrier()
        dist.destroy_process_group()
    """)
    script = tmp / f"{tag}.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n),
         str(tmp / f"{tag}.store"), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(n)]


def _finish_ranks(procs) -> list:
    """Each rank's last stdout line as JSON, by rank; a rank that fails or
    outlives ``RANK_TIMEOUT`` fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def _run_ranks(tmp, n, body, tag, args=()) -> list:
    return _finish_ranks(_start_ranks(tmp, n, body, tag, args))


#: (arch, mesh (data, model)) of the sharded-step cases
STEP_CASES = [("gemma2-2b", (2, 2)), ("gemma2-2b", (1, 2)),
              ("gemma2-2b", (2, 1)), ("granite-moe-1b-a400m", (1, 2))]
#: the sharded serving cases: attention split by heads with KV caches
#: split by heads; smollm's heads do not divide the axis (weights
#: gathered, caches split on head_dim); Mamba's and RG-LRU's states split
#: by channels; an encoder; MoE on the data group's tokens
SERVE_CASES = [("gemma2-2b", (2, 2)), ("smollm-135m", (2, 2)),
               ("falcon-mamba-7b", (2, 2)), ("recurrentgemma-2b", (1, 2)),
               ("whisper-small", (1, 2)), ("granite-moe-1b-a400m", (2, 2))]
SERVE_ATOL = 1e-5

_STEP_BODY = """
    from repro_torch.configs import get_config
    from repro_torch.models.convert import load_reference_params
    from repro_torch.models.parallel import gather_params, gather_tree
    from repro_torch.models.sharding import (
        distribute_model, make_activation_hook, named_sharding_tree,
        opt_state_specs, shard_batch)
    from repro_torch.models.train import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.elastic import make_mesh_from_devices, remesh_tree
    from repro_torch.tree import tree_from_paths
    cases = json.loads(args[0])
    out = []
    for arch, (nd, nm), path, got in cases:
        ref = np.load(path)
        tree = tree_from_paths({k[2:]: ref[k] for k in ref.files
                                if k.startswith("p/")}, "/")
        cfg = get_config(arch, smoke=True)
        model = load_reference_params(cfg, tree, device="cpu")
        mesh = make_mesh_from_devices(range(nd * nm), nm, device="cpu")
        if mesh.coords is None:
            out.append(None)
            continue
        ospecs = opt_state_specs(model, mesh)
        fresh = adamw_init(dict(model.named_parameters()))
        opt = {k: remesh_tree(fresh[k], mesh, ospecs[k]) for k in ("m", "v")}
        opt["step"] = fresh["step"]
        sharded = distribute_model(model, mesh)
        step = make_train_step(
            cfg, lr=1e-3, device="cpu",
            activation_hook=make_activation_hook(mesh,
                                                 sequence_parallel=False),
            grad_shardings=named_sharding_tree(mesh, ospecs["m"]))
        batch = {"tokens": ref["tokens"], "labels": ref["labels"]}
        sharded, opt, metrics = step(sharded, opt, shard_batch(batch, mesh))
        full = gather_params(sharded)
        m = gather_tree(opt["m"], ospecs["m"], mesh)
        if rank == 0:
            np.savez(got, **{k: v.numpy() for k, v in full.items()},
                     **{"m/" + k: v.numpy() for k, v in m.items()})
        out.append({"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "step": int(opt["step"]), "tally": mesh.tally})
    out.append(_serve_cases(json.loads(args[1])))
    print(json.dumps(out))
"""

_SERVE_BODY = """
def _serve_cases(cases):
    # the sharded prefill and decode (4 steps from per-slot positions)
    # against the one-device steps, the logits gathered
    from repro_torch.models.model import build_caches, init_model
    from repro_torch.models.parallel import vocab_split
    from repro_torch.models.serve import make_decode_step, make_prefill_step
    from repro_torch.models.sharding import cache_specs
    from repro_torch.runtime.elastic import remesh_tree
    out = []
    for arch, (nd, nm) in cases:
        cfg = get_config(arch, smoke=True)
        model = init_model(0, cfg, device="cpu")
        mesh = make_mesh_from_devices(range(nd * nm), nm, device="cpu")
        if mesh.coords is None:
            out.append(None)
            continue
        sharded = distribute_model(model, mesh)
        rng = np.random.default_rng(1)
        extra = {}
        if cfg.encoder is not None:
            extra["frames"] = (rng.normal(size=(
                4, cfg.encoder.n_frames, cfg.d_model)) * 0.02).astype(
                np.float32)

        def whole(logits):
            if vocab_split(sharded):
                logits = mesh.all_gather(logits, "model", 1)
            return mesh.all_gather(logits, "data", 0)
        prefill = make_prefill_step(cfg, device="cpu")
        toks = rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)
        worst = {"prefill": float((prefill(model, dict(
            extra, tokens=toks)) - whole(prefill(sharded, shard_batch(dict(
                extra, tokens=toks), mesh)))).abs().max())}
        decode = make_decode_step(cfg, device="cpu")
        one = build_caches(cfg, 4, 24, dtype=torch.float32, device="cpu")
        part = remesh_tree(one, mesh, cache_specs(one, mesh))
        pos, worst["decode"] = np.array([0, 1, 2, 0]), 0.0
        for _ in range(4):
            toks = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
            want, one = decode(model, one, dict(extra, tokens=toks, pos=pos))
            got, part = decode(sharded, part, dict(
                shard_batch(dict(extra, tokens=toks), mesh), pos=pos))
            worst["decode"] = max(worst["decode"], float(
                (want - whole(got)).abs().max()))
            pos = pos + 1
        out.append(worst)
    return out
"""


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """{case: (reference loss, grad norm), [each rank's result]}: the
    reference's jitted single-device step, then the port's sharded steps
    of every case in one world of 4 gloo ranks (a case's mesh takes the
    first ranks)."""
    from repro_torch.models.convert import _named, _port_tree
    tmp = tmp_path_factory.mktemp("sharded")
    inits = {}
    for arch in dict(STEP_CASES):
        rcfg = r_configs.get_config(arch, smoke=True)
        params = r_model.init_model(jax.random.PRNGKey(0), rcfg,
                                    dtype=jnp.float32)
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, rcfg.vocab, (8, 32)).astype(np.int32)
                 for k in ("tokens", "labels")}
        path = tmp / f"{arch}.npz"
        np.savez(path, **batch, **{
            "p/" + "/".join(str(getattr(k, "key", k)) for k in kp):
            np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]})
        inits[arch] = (rcfg, params, batch, str(path))
    cases = [(arch, mesh, inits[arch][3], str(tmp / f"got{i}.npz"))
             for i, (arch, mesh) in enumerate(STEP_CASES)]
    procs = _start_ranks(tmp, 4, textwrap.dedent(_SERVE_BODY)
                         + textwrap.dedent(_STEP_BODY), "steps",
                         (json.dumps(cases), json.dumps(SERVE_CASES)))
    # the reference's steps while the ranks run
    want = {}
    for arch, (rcfg, params, batch, _) in inits.items():
        new, opt, m = jax.jit(r_make_step(rcfg, lr=1e-3))(
            params, r_adamw_init(params), jax.tree.map(jnp.asarray, batch))
        cfg = get_config(arch, smoke=True)
        after, m1 = (_named(_port_tree(cfg, jax.tree.map(np.asarray, t),
                                       "cpu", None))
                     for t in (new, opt["m"]))
        want[arch] = (float(m["loss"]), float(m["grad_norm"]),
                      {k: v.numpy() for k, v in after.items()},
                      {k: v.numpy() for k, v in m1.items()})
    results = _finish_ranks(procs)
    steps = {case: (want[case[0]], [r[i] for r in results], dict(np.load(
        cases[i][3]))) for i, case in enumerate(STEP_CASES)}
    serve = {case: [r[-1][i] for r in results]
             for i, case in enumerate(SERVE_CASES)}
    return steps, serve


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in STEP_CASES])
def test_sharded_step_matches_reference(sharded_steps, case):
    (loss, norm, params, moments), ranks, got = sharded_steps[0][case]
    got_params = {k: v for k, v in got.items() if not k.startswith("m/")}
    nd, nm = case[1]
    live = [r for r in ranks if r is not None]
    assert len(live) == nd * nm and ranks[nd * nm:] == [None] * (4 - nd * nm)
    for r in live:
        assert abs(r["loss"] - loss) < LOSS_ATOL, (r["loss"], loss)
        assert abs(r["grad_norm"] - norm) <= NORM_RTOL * norm
        assert r["step"] == 1
    assert sorted(got_params) == sorted(params)
    worst = max(float(np.abs(got_params[k] - v).max())
                for k, v in params.items())
    assert worst < PARAM_ATOL, worst
    # the gradients leaf by leaf: m = 0.1 g after one step
    assert sorted(k[2:] for k in got if k.startswith("m/")) == sorted(moments)
    for k, w in moments.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got["m/" + k] - w).max())
        assert err <= M_TOL * scale, (k, err, scale)
    tally = live[0]["tally"]
    if nm > 1:       # the model axis sums partial outputs
        assert tally["all-reduce"] > 0 and tally["all-gather"] > 0
    if nd > 1:       # ZeRO-1: gradients reduce-scattered
        assert tally["reduce-scatter"] > 0


@pytest.mark.parametrize("case", SERVE_CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in SERVE_CASES])
def test_sharded_prefill_and_decode_match_one_device(sharded_steps, case):
    """The sharded prefill and four decode steps (per-slot positions, the
    caches under ``cache_specs``) give the one-device logits, gathered,
    within ``SERVE_ATOL``; the one-device steps are held to the
    reference's by ``tests/test_torch_serve.py``."""
    nd, nm = case[1]
    got = sharded_steps[1][case]
    assert got[nd * nm:] == [None] * (4 - nd * nm)
    for r in got[:nd * nm]:
        assert r["prefill"] < SERVE_ATOL and r["decode"] < SERVE_ATOL, r


_LOOP_BODY = """
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime.elastic import make_mesh_from_devices
    nd, nm, ck, fail = int(args[0]), int(args[1]), args[2], args[3]
    mesh = make_mesh_from_devices(range(world), nm, device="cpu")
    assert mesh.shape == {"data": nd, "model": nm}, mesh.shape
    run = dict(smoke=True, steps=6, batch=4, seq=32, ckpt_every=2, lr=1e-3)
    try:
        _, opt, losses = train_loop(
            "smollm-135m", ckpt_dir=ck, mesh=mesh,
            fail_at_step=None if fail == "-" else int(fail), **run)
        print(json.dumps({"losses": losses, "step": int(opt["step"])}))
    except RuntimeError as e:
        print(json.dumps({"crashed": str(e)}))
"""


def test_train_loop_resumes_on_a_smaller_mesh(tmp_path):
    run = dict(smoke=True, steps=6, batch=4, seq=32, ckpt_every=2, lr=1e-3)
    ck = tmp_path / "ck"
    procs = _start_ranks(tmp_path, 4, _LOOP_BODY, "crash", (2, 2, ck, 3))
    _, _, want = train_loop("smollm-135m", device="cpu", **run)
    crashed = _finish_ranks(procs)
    assert all("injected failure at step 3" in r["crashed"] for r in crashed)
    # two survivors: the largest mesh they form with a 1-wide model axis
    resumed = _run_ranks(tmp_path, 2, _LOOP_BODY, "resume", (2, 1, ck, "-"))
    for r in resumed:
        assert r["step"] == 6
        np.testing.assert_allclose(r["losses"], want[2:], **RESUME_TOL)


_ELASTIC_BODY = """
    from repro_torch.models.parallel import gather_tree
    from repro_torch.runtime.elastic import make_mesh_from_devices, remesh_tree
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    spec = {"w": ("data", "model")}
    mesh = make_mesh_from_devices(range(world), n_model=2, device="cpu")
    local = remesh_tree(tree, mesh, spec)
    full = gather_tree(local, spec, mesh)["w"].numpy()
    print(json.dumps({"shape": mesh.shape, "local": list(local["w"].shape),
                      "equal": bool(np.array_equal(full, tree["w"]))}))
"""


def test_elastic_remesh_eight_to_four_ranks(tmp_path):
    """The reference's ``test_elastic_remesh_subprocess``: a host tree
    laid onto a mesh of 8 ranks, then (after a node loss) onto the mesh
    the 4 survivors form, gathering back to the same array each time."""
    for world, shape, local in ((8, {"data": 4, "model": 2}, [2, 4]),
                                (4, {"data": 2, "model": 2}, [4, 4])):
        for r in _run_ranks(tmp_path, world, _ELASTIC_BODY, f"el{world}"):
            assert r == {"shape": shape, "local": local, "equal": True}
