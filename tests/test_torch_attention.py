"""The port's APRIL block-sparse attention held to the JAX package: the
interval tables array for array; ``april_attention`` on CPU tensors (the
plain version) against the reference's Pallas kernel in interpret mode and
its dense oracle, on the reference's own test grid, f32 and bf16 cases at D
128 and 256 and a bf16 case with kv blocks of 96 keys (``TEST_GRID``,
which the on-card check shares); the dense oracle
against the reference's; ``april_attention_blocks`` against
``april_attention_pallas`` on hand-made tables; and the wrapper's checks.
Inputs are made with numpy from a seed and rounded to bf16 in each
framework from the same float32 arrays. Tolerances are the reference's:
2e-5 in float32, 2e-2 in bf16 (atol and rtol). The CUDA kernels run only on
the card (``cuda`` marker), where bf16 outputs are also gated on their row
error against the plain version (``ROW_REL_TOL``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.april_attention import (  # noqa: E402
    april_attention as r_april_attention)
from repro.kernels.april_attention.april_attention import (  # noqa: E402
    april_attention_pallas)
from repro.kernels.april_attention.ops import (  # noqa: E402
    build_block_intervals as r_build_block_intervals)
from repro.kernels.april_attention.ref import (  # noqa: E402
    april_attention_ref as r_april_attention_ref, dense_mask as r_dense_mask)

from repro_torch.kernels.april_attention import (  # noqa: E402
    ROW_REL_TOL, TEST_GRID, TEST_TOL, april_attention, april_attention_blocks,
    april_attention_plain, april_attention_ref, build_block_intervals,
    dense_mask, row_rel_err)

TOL = TEST_TOL
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

#: (dtype, BH, S, D, block_q, block_kv, mask_kind, window, softcap, seed):
#: the port's test grid, which holds tests/test_kernels.py's cases, and
#: the D 64 sweep among them
GRID = list(TEST_GRID)
SWEEP = [case for case in GRID if case[3] == 64]


def _arrays(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax(arrays, dtype):
    return [jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bq,bkv", [(64, 64), (128, 64), (64, 128)])
@pytest.mark.parametrize("kind,window", [
    ("causal", 0), ("full", 0), ("local", 1), ("local", 63), ("local", 64),
    ("local", 96), ("local", 2048)])
def test_block_intervals_equal_reference(kind, window, bq, bkv):
    for Sq, Skv in [(512, 512), (256, 512), (512, 256)]:
        got = build_block_intervals(Sq, Skv, bq, bkv, kind, window)
        want = r_build_block_intervals(Sq, Skv, bq, bkv, kind, window)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,BH,S,D,bq,bkv,kind,window,softcap,seed", GRID)
def test_attention_equals_reference_kernel(dtype, BH, S, D, bq, bkv, kind,
                                           window, softcap, seed):
    arrays = _arrays(seed, (BH, S, D))
    kw = dict(mask_kind=kind, window=window, softcap=softcap)
    before = april_attention_blocks.launches
    got = april_attention(*_torch(arrays, dtype), block_q=bq, block_kv=bkv,
                          **kw)
    assert april_attention_blocks.launches == before   # CPU: plain version
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (BH, S, D)
    jq = _jax(arrays, dtype)
    want = r_april_attention(*jq, block_q=bq, block_kv=bkv, interpret=True,
                             **kw)
    _close(got, want, dtype)
    _close(got, r_april_attention_ref(*jq, **kw), dtype)


@pytest.mark.parametrize("dtype,BH,S,D,bq,bkv,kind,window,softcap,seed",
                         SWEEP)
def test_dense_oracle_equals_reference(dtype, BH, S, D, bq, bkv, kind,
                                       window, softcap, seed):
    arrays = _arrays(seed, (BH, S, D))
    kw = dict(mask_kind=kind, window=window, softcap=softcap)
    got = april_attention_ref(*_torch(arrays, dtype), **kw)
    want = r_april_attention_ref(*_jax(arrays, dtype), **kw)
    assert got.dtype == TORCH_DTYPES[dtype]
    _close(got, want, dtype)
    np.testing.assert_array_equal(dense_mask(S, S + 64, kind, window).numpy(),
                                  np.asarray(r_dense_mask(S, S + 64, kind,
                                                          window)))


#: hand-made tables over S 256 in blocks of 64 (nq = nk = 4), with the mask
#: each is read under
TABLES = {
    # q block 0 visits nothing; an F-run inside the A-interval; a visit that
    # starts past the first blocks with an empty F-run
    "causal": ("causal", 0, [[0, 0, 0, 0], [0, 0, 1, 2], [0, 1, 2, 3],
                             [2, 2, 2, 4]]),
    # the first visited block is fully masked for some queries of q block 2
    # and for every query of q block 3 (the finite NEG_INF carries exp(0)
    # until a later block rescales it away); every F-run empty
    "local-32": ("local", 32, [[0, 0, 0, 1], [0, 0, 0, 2], [1, 1, 1, 3],
                               [1, 1, 1, 4]]),
    # A-intervals beyond the grid are clipped to it
    "full": ("full", 0, [[-1, 0, 4, 9], [0, 0, 0, 4], [1, 1, 3, 3],
                         [3, 3, 3, 4]]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_table_steers_like_the_pallas_kernel(table, dtype):
    kind, window, rows = TABLES[table]
    iv = np.asarray(rows, np.int32)
    arrays = _arrays(5, (2, 256, 64))
    kw = dict(block_q=64, block_kv=64, mask_kind=kind, window=window,
              softcap=20.0 if kind == "local" else None)
    got = april_attention_blocks(*_torch(arrays, dtype),
                                 torch.from_numpy(iv), **kw)
    want = april_attention_pallas(*_jax(arrays, dtype), jnp.asarray(iv),
                                  interpret=True, **kw)
    _close(got, want, dtype)
    if table == "causal":
        assert not got[:, :64].float().any()         # an empty A-interval
    # the plain version is what the wrapper ran
    again = april_attention_plain(*_torch(arrays, dtype), torch.from_numpy(iv),
                                  scale=1 / 8, **kw)
    assert torch.equal(got, again)


def _bad_calls():
    q = torch.zeros(1, 128, 64)
    iv = torch.from_numpy(build_block_intervals(128, 128, 64, 64, "causal"))
    return {
        "ragged S": ((torch.zeros(1, 100, 64),) * 3, iv, {}),
        "dtype mismatch": ((q, q.to(torch.bfloat16), q), iv, {}),
        "device mismatch": ((q, q.to("meta"), q), iv, {}),
        "BH mismatch": ((q, torch.zeros(2, 128, 64), torch.zeros(2, 128, 64)),
                        iv, {}),
        "not contiguous": ((q, torch.zeros(1, 64, 128).transpose(1, 2), q),
                           iv, {}),
        "table shape": ((q,) * 3, iv[:, :3].contiguous(), {}),
        "table rows": ((q,) * 3, iv[:1], {}),
        "table dtype": ((q,) * 3, iv.long(), {}),
        "mask kind": ((q,) * 3, iv, {"mask_kind": "sliding"}),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_raises(case):
    qkv, iv, kw = _bad_calls()[case]
    kw = {"block_q": 64, "block_kv": 64, **kw}
    with pytest.raises((ValueError, TypeError)):
        april_attention_blocks(*qkv, iv, **kw)
    if case not in ("table shape", "table rows", "table dtype"):
        with pytest.raises((ValueError, TypeError)):
            april_attention(*qkv, **kw)


#: what the reference computes and the kernels are not built for: (dtype,
#: D, block_q); S 256, blocks of 64 keys, local 96 with softcap 30
BEYOND_KERNELS = {"float64": ("float64", 64, 64),
                  "D the kernel lacks": ("float32", 48, 64),
                  "block_q the kernel lacks": ("float32", 64, 32)}


@pytest.mark.parametrize("case", sorted(BEYOND_KERNELS))
def test_cpu_computes_beyond_the_kernels(case):
    """On the CPU the plain version takes what the kernels do not, as the
    reference does: f64, a head width and a q block without a kernel
    instance. The reference runs without x64, so its f64 output is f32:
    the port's f64 result is held to the port's dense oracle in f64, and
    to the reference's kernel and oracle at the f32 tolerance."""
    dtype, D, bq = BEYOND_KERNELS[case]
    arrays = _arrays(17, (2, 256, D))
    kw = dict(mask_kind="local", window=96, softcap=30.0)
    qkv = [torch.from_numpy(a.astype(np.float64)).to(getattr(torch, dtype))
           for a in arrays]
    before = april_attention_blocks.launches
    got = april_attention(*qkv, block_q=bq, block_kv=64, **kw)
    assert april_attention_blocks.launches == before   # CPU: plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 256, D)
    dense = april_attention_ref(*qkv, **kw)
    assert dense.dtype == got.dtype
    tol = 1e-12 if dtype == "float64" else TOL["float32"]
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=tol,
                               rtol=tol)
    jq = _jax(arrays, "float32")
    want = r_april_attention(*jq, block_q=bq, block_kv=64, interpret=True,
                             **kw)
    _close(got, want, "float32")
    _close(got, r_april_attention_ref(*jq, **kw), "float32")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BEYOND_KERNELS))
def test_kernel_raises_beyond_its_instances(case, cuda_device):
    """On a CUDA tensor what the kernels are not built for raises; there is
    no fallback to the plain version."""
    dtype, D, bq = BEYOND_KERNELS[case]
    qkv = [torch.zeros(2, 256, D, dtype=getattr(torch, dtype),
                       device=cuda_device)] * 3
    iv = torch.from_numpy(build_block_intervals(256, 256, bq, 64, "causal"))
    before = april_attention_blocks.launches
    with pytest.raises((ValueError, TypeError)):
        april_attention(*qkv, block_q=bq, block_kv=64)
    with pytest.raises((ValueError, TypeError)):
        april_attention_blocks(*qkv, iv.to(cuda_device), block_q=bq,
                               block_kv=64)
    assert april_attention_blocks.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,BH,S,D,bq,bkv,kind,window,softcap,seed", GRID)
def test_kernel_equals_plain_version(dtype, BH, S, D, bq, bkv, kind, window,
                                     softcap, seed, cuda_device):
    qkv = [t.to(cuda_device) for t in _torch(_arrays(seed, (BH, S, D)),
                                             dtype)]
    kw = dict(block_q=bq, block_kv=bkv, mask_kind=kind, window=window,
              softcap=softcap)
    before = april_attention_blocks.launches
    got = april_attention(*qkv, **kw)
    torch.cuda.synchronize()
    assert april_attention_blocks.launches == before + 1
    iv = torch.from_numpy(build_block_intervals(S, S, bq, bkv, kind, window))
    want = april_attention_plain(*qkv, iv.to(cuda_device),
                                 scale=1.0 / D ** 0.5, **kw)
    _close(got.cpu(), want.cpu(), dtype)
    if dtype == "bfloat16":
        assert row_rel_err(got, want) <= ROW_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_f32_kernel_instances_equal_plain_version(D, bq, cuda_device):
    """Every instance of the CUDA-core kernel at 2e-5 against the plain
    version: a causal mask, a local window with a softcap over kv blocks
    of 96 keys (tiles straddle kv blocks), hand-made tables with empty and
    clipped A-intervals; and no instance spills."""
    from repro_torch.kernels.april_attention import kernel_attrs
    attrs = kernel_attrs(torch.float32)[(D, bq)]
    assert attrs["spill_bytes"] == 0, attrs
    for S, bkv, kind, window, cap in ((512, 64, "causal", 0, None),
                                      (384, 96, "local", 100, 30.0)):
        qkv = [t.to(cuda_device) for t in _torch(_arrays(D + S, (2, S, D)),
                                                 "float32")]
        kw = dict(block_q=bq, block_kv=bkv, mask_kind=kind, window=window,
                  softcap=cap)
        got = april_attention(*qkv, **kw)
        iv = torch.from_numpy(build_block_intervals(S, S, bq, bkv, kind,
                                                    window))
        want = april_attention_plain(*qkv, iv.to(cuda_device),
                                     scale=1.0 / D ** 0.5, **kw)
        _close(got.cpu(), want.cpu(), "float32")
    if bq == 64:
        for table in sorted(TABLES):
            kind, window, rows = TABLES[table]
            iv = torch.tensor(rows, dtype=torch.int32, device=cuda_device)
            qkv = [t.to(cuda_device)
                   for t in _torch(_arrays(5, (2, 256, D)), "float32")]
            kw = dict(block_q=64, block_kv=64, mask_kind=kind,
                      window=window, softcap=20.0 if kind == "local" else None)
            got = april_attention_blocks(*qkv, iv, **kw)
            want = april_attention_plain(*qkv, iv, scale=D ** -0.5, **kw)
            _close(got.cpu(), want.cpu(), "float32")
