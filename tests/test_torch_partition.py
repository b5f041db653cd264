"""The port's partitioning layer held to the JAX package's: the chunked
dataset streams and their in-memory concatenation bit for bit; the
mixed-order scaling and verdicts on random and hypothesis lists; the
uniform partitioning, quadrants, tile hits, square extents, reference
partitions and the ownership rule over a skew-split cover; per-partition
builds; the launcher's packing and bucketing helpers; the backend-name
errors; the work queue's lease expiry and the straggler monitor. Host
numpy throughout (the reference's test sizes); tolerance zero."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import granularity as r_gran  # noqa: E402
from repro.core import join as r_join  # noqa: E402
from repro.core import partition as r_part  # noqa: E402
from repro.core.april import build_april as r_build_april  # noqa: E402
from repro.datagen import iter_dataset_chunks as r_iter_chunks  # noqa: E402
from repro.datagen import make_chunked_dataset as r_chunked  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.spatial import refine as r_refine  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402
from repro.spatial.mbr_join import _pad_rows_pow2 as r_pad  # noqa: E402

from repro_torch import JoinPlan, make_dataset  # noqa: E402
from repro_torch.core import granularity, partition  # noqa: E402
from repro_torch.core import join  # noqa: E402
from repro_torch.core.april import build_april  # noqa: E402
from repro_torch.datagen import (iter_dataset_chunks,  # noqa: E402
                                 make_chunked_dataset)
from repro_torch.runtime import StragglerMonitor, WorkQueue  # noqa: E402
from repro_torch.spatial import get_filter, refine  # noqa: E402
from repro_torch.spatial.mbr_join import _pad_rows_pow2  # noqa: E402

N_ORDER = 7
CHUNK_CASES = [("T1", 5, 280, 100), ("T2", 6, 400, 100), ("T1", 9, 330, 128),
               ("T10", 2, 45, 64)]


@pytest.fixture(scope="module")
def layers():
    """T1 280 x T2 400 of the chunk streams, the reference's and the
    port's."""
    return (r_chunked("T1", seed=5, count=280, chunk_size=100),
            r_chunked("T2", seed=6, count=400, chunk_size=100),
            make_chunked_dataset("T1", seed=5, count=280, chunk_size=100),
            make_chunked_dataset("T2", seed=6, count=400, chunk_size=100))


@pytest.mark.parametrize("name,seed,count,chunk", CHUNK_CASES)
def test_chunk_streams_bit_identical(name, seed, count, chunk):
    ours = list(iter_dataset_chunks(name, seed=seed, count=count,
                                    chunk_size=chunk))
    ref = list(r_iter_chunks(name, seed=seed, count=count, chunk_size=chunk))
    assert len(ours) == len(ref) == -(-count // chunk)
    for a, b in zip(ours, ref):
        assert a.verts.tobytes() == b.verts.tobytes()
        assert a.verts.shape == b.verts.shape
        assert np.array_equal(a.nverts, b.nverts)
        assert a.mbrs.tobytes() == b.mbrs.tobytes()
    whole = make_chunked_dataset(name, seed=seed, count=count,
                                 chunk_size=chunk)
    want = r_chunked(name, seed=seed, count=count, chunk_size=chunk)
    assert whole.verts.tobytes() == want.verts.tobytes()
    assert np.array_equal(whole.nverts, want.nverts)
    assert whole.verts.shape == want.verts.shape


def test_chunked_dataset_options_bit_identical():
    kw = dict(count=150, chunk_size=64, avg_vertices=12, avg_radius=0.01,
              map_seed=3)
    a = make_chunked_dataset("X", seed=4, **kw)
    b = r_chunked("X", seed=4, **kw)
    assert a.verts.tobytes() == b.verts.tobytes()
    assert np.array_equal(a.nverts, b.nverts)


def _random_lists(rng, n, hi):
    """A sorted, disjoint, non-touching half-open uint64 list."""
    if n == 0:
        return np.zeros((0, 2), np.uint64)
    cuts = np.sort(rng.choice(np.arange(1, hi), size=2 * n, replace=False))
    return cuts.reshape(-1, 2).astype(np.uint64)


@pytest.mark.parametrize("seed", range(6))
def test_scale_intervals_and_mixed_verdicts_random(seed):
    rng = np.random.default_rng(seed)
    n_fine, n_coarse = 8, int(rng.integers(4, 9))
    hi = 1 << (2 * n_fine)
    for _ in range(20):
        a = _random_lists(rng, int(rng.integers(0, 12)), hi)
        got = granularity.scale_intervals(a, n_fine, n_coarse)
        want = r_gran.scale_intervals(a, n_fine, n_coarse)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        ac = _random_lists(rng, int(rng.integers(0, 6)), 1 << (2 * n_coarse))
        fc = ac[: len(ac) // 2]
        assert granularity.mixed_order_verdict_pair(
            a, a[:1], n_fine, ac, fc, n_coarse) == \
            r_gran.mixed_order_verdict_pair(a, a[:1], n_fine, ac, fc,
                                            n_coarse)


@given(st.lists(st.integers(0, (1 << 16) - 1), max_size=16, unique=True),
       st.lists(st.integers(0, (1 << 10) - 1), max_size=8, unique=True),
       st.integers(5, 8))
@settings(max_examples=60, deadline=None)
def test_mixed_order_property(fine, coarse, n_coarse):
    def lists(vals, top):
        v = np.sort(np.asarray(vals, np.int64)) * 2
        v = v[v + 1 < top]
        return np.stack([v, v + 1], axis=1).astype(np.uint64) if len(v) \
            else np.zeros((0, 2), np.uint64)
    a = lists(fine, 1 << 16)
    ac = lists(coarse, 1 << (2 * n_coarse))
    got = granularity.scale_intervals(a, 8, n_coarse)
    assert np.array_equal(got, r_gran.scale_intervals(a, 8, n_coarse))
    assert granularity.mixed_order_verdict_pair(a, a, 8, ac, ac[::2],
                                                n_coarse) == \
        r_gran.mixed_order_verdict_pair(a, a, 8, ac, ac[::2], n_coarse)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_partition_space_matches(layers, k):
    R0, S0, R, S = layers
    ours = partition.partition_space([R, S], k)
    ref = r_part.partition_space([R0, S0], k)
    assert ours.parts_per_dim == ref.parts_per_dim and len(ours) == len(ref)
    for a, b in zip(ours.partitions, ref.partitions):
        assert a.tile == b.tile
        assert (a.extent.x0, a.extent.y0, a.extent.side) == \
            (b.extent.x0, b.extent.y0, b.extent.side)
        assert a.obj_idx.keys() == b.obj_idx.keys()
        for key in a.obj_idx:
            assert np.array_equal(a.obj_idx[key], b.obj_idx[key])


def test_quadrants_hits_extents_and_ownership(layers):
    R0, S0, R, S = layers
    tiles = [(0.0, 0.0, 0.5, 0.5), (0.25, 0.5, 0.75, 1.0),
             (0.1, 0.2, 0.3, 0.9)]
    for t in tiles:
        assert partition.quadrants(t) == r_part.quadrants(t)
        for m in (R.mbrs, S.mbrs):
            hit = partition.tile_hits(m, t)
            assert np.array_equal(hit, r_part.tile_hits(m, t))
            e, f = partition.square_extent(m[hit], t), \
                r_part.square_extent(m[hit], t)
            assert (e.x0, e.y0, e.side) == (f.x0, f.y0, f.side)
        e, f = partition.square_extent(np.zeros((0, 4)), t), \
            r_part.square_extent(np.zeros((0, 4)), t)
        assert (e.x0, e.y0, e.side) == (f.x0, f.y0, f.side)
    # a skew-split cover: the base 2x2 with its first tile split 2x2
    cover = np.asarray(partition.quadrants((0.0, 0.0, 0.5, 0.5))
                       + [(0.5, 0.0, 1.0, 0.5), (0.0, 0.5, 0.5, 1.0),
                          (0.5, 0.5, 1.0, 1.0)])
    pairs = JoinPlan(R, S, n_order=N_ORDER, device="cpu").candidates()
    mr, ms = R.mbrs[pairs[:, 0]], S.mbrs[pairs[:, 1]]
    own = partition.owner_tiles(cover, mr, ms)
    assert (own >= 0).all()
    assert np.array_equal(own, r_part.owner_tiles(cover, mr, ms))
    # a cover with a hole reads -1 there
    assert np.array_equal(partition.owner_tiles(cover[1:], mr, ms),
                          r_part.owner_tiles(cover[1:], mr, ms))
    for k in (1, 2, 4):
        got = partition.reference_partitions(k, mr, ms)
        assert np.array_equal(got, r_part.reference_partitions(k, mr, ms))
        assert partition.reference_partition(k, mr[3], ms[3]) == \
            r_part.reference_partition(k, mr[3], ms[3]) == got[3]


@pytest.mark.parametrize("method", ["april", "ri", "none"])
def test_per_partition_builds_match(layers, method):
    R0, S0, R, S = layers
    ours = partition.partition_space([R, S], 2)
    ref = r_part.partition_space([R0, S0], 2)
    got = ours.build_approx(get_filter(method), S, N_ORDER, side="s")
    want = ref.build_approx(r_get_filter(method), S0, N_ORDER, side="s")
    assert [a is None for a in got] == [b is None for b in want]
    for a, b in zip(got, want):
        if a is None:
            continue
        if method == "none":
            assert a.store is None and b.store is None
            continue
        sa, sb = a.store, b.store
        for name in ("a_off", "a_ints", "f_off", "f_ints") if method == \
                "april" else ("off", "ints", "bit_off", "bits"):
            assert np.array_equal(getattr(sa, name), getattr(sb, name)), name
    # the torch build backend builds one partition at a time, the same
    # stores; the reference's name raises, naming the port's
    torch_built = ours.build_approx(get_filter("april"), S, N_ORDER,
                                    side="s", build_backend="torch",
                                    device="cpu")
    host = ours.build_april(S, N_ORDER, parallel=False)
    for a, b, c in zip(torch_built, host,
                       ref.build_april(S0, N_ORDER, parallel=False)):
        if a is None:
            assert b is None and c is None
            continue
        assert np.array_equal(a.store.a_ints, b.a_ints)
        assert np.array_equal(b.a_ints, c.a_ints)
        assert np.array_equal(b.f_off, c.f_off)
    with pytest.raises(ValueError, match="'torch'"):
        ours.build_approx(get_filter("april"), S, N_ORDER,
                          build_backend="jnp")


def test_packing_helpers_match(layers):
    R0, S0, R, S = layers
    st_r, st_s = build_april(R, N_ORDER), build_april(S, N_ORDER)
    rt_r = r_build_april(R0, N_ORDER)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, len(R), 97)
    for kind in ("A", "F"):
        for pad in (None, 8, 64):
            got = join.pack_lists(st_r, idx, kind, pad_to=pad)
            want = r_join.pack_lists(rt_r, idx, kind, pad_to=pad)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    got = join.pack_csr_intervals(st_s.a_off, st_s.a_ints, np.zeros(0, int))
    want = r_join.pack_csr_intervals(st_s.a_off, st_s.a_ints,
                                     np.zeros(0, int))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    for n, mult in ((0, 1), (1, 1), (5, 2), (33, 4), (64, 8)):
        xs = [np.arange(n), np.ones((n, 2))]
        (g, gn), (w, wn) = _pad_rows_pow2(xs, multiple=mult), \
            r_pad(xs, multiple=mult)
        assert gn == wn and all(np.array_equal(a, b) for a, b in zip(g, w))
    pairs = JoinPlan(R, S, n_order=N_ORDER, device="cpu").candidates()
    got = list(refine.iter_pair_chunks(R, S, pairs))
    want = list(r_refine.iter_pair_chunks(R0, S0, pairs))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and np.array_equal(a, b)


def test_reference_backend_names_raise():
    from repro_torch.launch.spatial_join import run_join
    for kw, port in ((dict(backend="jnp"), "'torch'"),
                     (dict(backend="pallas"), "'cuda'"),
                     (dict(refine_backend="jnp"), "'device64'"),
                     (dict(mbr_backend="jnp"), "'torch'"),
                     (dict(build_backend="jnp"), "'torch'")):
        with pytest.raises(ValueError, match=port):
            run_join(count_r=20, count_s=20, n_order=6, device="cpu", **kw)


def test_work_queue_lease_expiry():
    q = WorkQueue([1, 2, 3], lease_seconds=0.01)
    a = q.acquire()
    b = q.acquire()
    q.complete(a)
    time.sleep(0.05)          # b's lease expires
    c = q.acquire()           # 3
    d = q.acquire()           # b, taken back
    assert {c, d} == {3, b}
    assert q.acquire() is None and not q.finished
    q.complete(c)
    q.complete(d)
    assert q.finished and q.done == {1, 2, 3}


def test_straggler_monitor():
    # a generous threshold: one slow step among fast ones, flagged once
    mon = StragglerMonitor(threshold=5.0)
    for _ in range(3):
        mon.start()
        time.sleep(0.002)
        assert mon.stop() is False
    mon.start()
    time.sleep(0.25)
    assert mon.stop() is True
    assert len(mon.flagged) == 1 and mon.flagged[0][0] == 3
    assert mon.step_idx == 4


def test_reference_dataset_unchanged():
    """The chunked and per-polygon generators are separate draws, in both
    packages alike."""
    a = make_dataset("T1", seed=5, count=100)
    b = r_make_dataset("T1", seed=5, count=100)
    c = make_chunked_dataset("T1", seed=5, count=100, chunk_size=100)
    assert a.verts.tobytes() == b.verts.tobytes()
    assert not np.array_equal(a.nverts, c.nverts) or \
        a.verts.tobytes() != c.verts.tobytes()
