"""Plain PyTorch versions of the APRIL block-sparse attention kernel.

:func:`dense_mask` and :func:`april_attention_ref` are the dense oracle:
f32 attention over the whole (q, k) grid with the causal, local(window) or
full mask applied everywhere. :func:`april_attention_plain` computes what
the kernel computes: for each q block it visits the kv blocks of its
A-interval ``[a_lo, a_hi)`` in ascending order, masks only the Partial
blocks outside the F-run ``[f_lo, f_hi)``, and runs the flash-attention
online softmax in f32 over them, with the finite ``NEG_INF`` for masked
scores, ``p`` rounded to v's dtype before the PV product and ``l == 0``
read as 1 in the final divide. It batches every q block into one step per
visited offset, so a step's products cover the whole grid. Runs on any
device; the CPU tests and the on-card comparison in ``chip_smoke.py`` use
it, and both read their test grid from :data:`TEST_GRID`.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "MASK_KINDS", "TEST_GRID", "TEST_TOL", "ROW_REL_TOL",
           "dense_mask", "row_rel_err", "april_attention_ref",
           "april_attention_plain"]

#: the masked score: finite, so a row whose first visited block is fully
#: masked carries exp(0) until a later block rescales it away
NEG_INF = -1e30
MASK_KINDS = ("causal", "local", "full")

#: the kernel's test grid, one tuple a case: (dtype, BH, S, D, block_q,
#: block_kv, mask_kind, window, softcap, seed). First the JAX package's own
#: cases (``tests/test_kernels.py``): BH 2, S 256, D 64, blocks 64, f32 and
#: bf16 over causal, local 96, local 64 with softcap 30 and full; causal at
#: D 32 with blocks 128/64 and 64/128. Then f32 and bf16 at the head
#: widths of the full-width layers, blocks 128: D 256 local 160 with
#: softcap 30, and D 128 causal; and bf16 with kv blocks of 96 keys (S 384,
#: q blocks 64, local 100), which the tensor-core kernel walks in tiles of
#: 32 keys, the first of them fully masked for some rows.
TEST_GRID = tuple(
    [(dt, 2, 256, 64, 64, 64, kind, window, cap, 11)
     for dt in ("float32", "bfloat16")
     for kind, window, cap in (("causal", 0, None), ("local", 96, None),
                               ("local", 64, 30.0), ("full", 0, None))]
    + [("float32", 1, S, 32, bq, bkv, "causal", 0, None, S)
       for S, bq, bkv in ((256, 128, 64), (512, 64, 128))]
    + [(dt, 2, 512, 256, 128, 128, "local", 160, 30.0, seed)
       for dt, seed in (("float32", 31), ("bfloat16", 41))]
    + [(dt, 2, 512, 128, 128, 128, "causal", 0, None, seed)
       for dt, seed in (("float32", 32), ("bfloat16", 42))]
    + [("bfloat16", 2, 384, 64, 64, 96, "local", 100, None, 43)])
#: the test grid's tolerances by dtype, atol and rtol (the reference's)
TEST_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the gate on bf16 outputs beside the allclose tolerances: the largest
#: row error (:func:`row_rel_err`) a kernel may show against its plain
#: version. A sound kernel reads about 0.03 (one bf16 ulp of a row's
#: largest values, and p rounded to bf16 under another running max); a
#: kernel that drops a kv block, the softcap or a key of the window reads
#: several times more than 1
ROW_REL_TOL = 0.1


def dense_mask(Sq: int, Skv: int, mask_kind: str, window: int = 0,
               device=None) -> torch.Tensor:
    """[Sq, Skv] bool: may query ``q`` attend key ``k``?"""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    if mask_kind == "causal":
        return kpos <= qpos
    if mask_kind == "local":
        return (kpos <= qpos) & (kpos > qpos - window)
    return torch.ones((Sq, Skv), dtype=torch.bool, device=device)


def row_rel_err(got, want) -> float:
    """The largest over output rows of max |got - want| over the RMS of the
    ``want`` row (an all-zero row counts against 1)."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    rms = w.square().mean(-1).sqrt()
    return float((err / torch.where(rms > 0, rms, 1.0)).max())


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 inputs compute in f64, every other dtype in f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def april_attention_ref(q, k, v, *, scale=None, mask_kind="causal",
                        window=0, softcap=None):
    """Dense masked attention in f32 (f64 for f64 inputs); rows with no
    allowed key are 0."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    ct = _compute_dtype(q.dtype)
    scale = scale if scale is not None else (1.0 / D ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.to(ct), k.to(ct)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = dense_mask(Sq, Skv, mask_kind, window, device=q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bqk,bkd->bqd", p, v.to(ct))
    row_any = mask.any(dim=1)[None, :, None]
    out = torch.where(row_any, out, 0.0)
    return out.to(q.dtype)


def april_attention_plain(q, k, v, intervals, *, scale, block_q, block_kv,
                          mask_kind, window, softcap):
    """[BH, Sq, D] in q's dtype: block-sparse attention steered by the
    [nq, 4] table of (a_lo, f_lo, f_hi, a_hi) rows in kv-block units. The
    A-interval is clipped to the kv blocks that exist, as the TPU grid
    clips it. f64 inputs compute in f64, every other dtype in f32."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    nq, nk = Sq // block_q, Skv // block_kv
    dev = q.device
    ct = _compute_dtype(q.dtype)
    iv = intervals.to(device=dev, dtype=torch.int64)
    a_lo = iv[:, 0].clamp(0, nk)
    f_lo, f_hi = iv[:, 1], iv[:, 2]
    a_hi = iv[:, 3].clamp(0, nk)
    n_steps = int((a_hi - a_lo).clamp(min=0).max()) if nq else 0
    qb = q.reshape(BH, nq, block_q, D).to(ct)
    kb = k.reshape(BH, nk, block_kv, D).to(ct)
    vb = v.reshape(BH, nk, block_kv, D)
    m = torch.full((BH, nq, block_q, 1), NEG_INF, dtype=ct, device=dev)
    l = torch.zeros((BH, nq, block_q, 1), dtype=ct, device=dev)
    acc = torch.zeros((BH, nq, block_q, D), dtype=ct, device=dev)
    qpos = (torch.arange(nq, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev))[:, :, None]   # [nq, bq, 1]
    koff = torch.arange(block_kv, device=dev)
    for j in range(n_steps):
        ki = a_lo + j                                           # [nq]
        live = (ki < a_hi)[None, :, None, None]
        kic = ki.clamp(max=nk - 1)
        s = torch.matmul(qb, kb[:, kic].transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = (kic[:, None] * block_kv + koff)[:, None, :]     # [nq, 1, bkv]
        if mask_kind == "causal":
            allowed = kpos <= qpos
        elif mask_kind == "local":
            allowed = (kpos <= qpos) & (kpos > qpos - window)
        else:
            allowed = torch.ones_like(kpos <= qpos)
        partial = ((ki < f_lo) | (ki >= f_hi))[:, None, None]
        s = torch.where(partial & ~allowed, NEG_INF, s)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).to(ct), vb[:, kic].to(ct))
        acc = torch.where(live, acc * alpha + pv, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(BH, Sq, D).to(q.dtype)
