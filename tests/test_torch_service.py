"""The port's online join service held to the JAX package's: a port
``JoinService`` (``device="cpu"``) and a reference one (numpy staged
backends) take the same submissions, mutations and drains and give the
same ticket pair arrays, group counts, service stats and cache stats
(hits and evictions under a small budget too); ``window`` requests,
submission errors, the background worker and its failures, the
concurrency hammer at reduced counts with the lock order checked, the
checkpoint format in both directions, and ``run_serve`` against the
reference's. Small sizes, on the CPU; tolerance zero."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.launch import serve_join as r_serve_join  # noqa: E402
from repro.runtime import checkpoint as r_checkpoint  # noqa: E402
from repro.spatial import JoinService as RJoinService  # noqa: E402

from repro_torch import JoinPlan, PolygonDataset, make_dataset  # noqa: E402
from repro_torch.core import join  # noqa: E402
from repro_torch.launch import serve_join  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.spatial import JoinService, StoreCache, get_filter  # noqa: E402,E501

N_ORDER = 6
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results", "method", "predicate", "plan_mode")


@pytest.fixture(scope="module")
def data():
    """T1 80 registered, T2 24 as query polygons: the reference's
    datasets and the port's."""
    return (r_make_dataset("T1", seed=51, count=80),
            r_make_dataset("T2", seed=52, count=24),
            make_dataset("T1", seed=51, count=80),
            make_dataset("T2", seed=52, count=24))


def _services(data, **kw):
    """(port service, reference service), each with the layer registered
    as ``"d"``; the port's on the CPU with its default backends."""
    R0, _, R, _ = data
    port_mode = kw.pop("port_pipeline_mode", "staged")
    ours = JoinService(n_order=N_ORDER, device="cpu",
                       pipeline_mode=port_mode, **kw)
    ref = RJoinService(n_order=N_ORDER, **kw)
    ours.register_dataset("d", R)
    ref.register_dataset("d", R0)
    return ours, ref


def _drive(svc, Q, trace, mutate_every, drain_every, submit_kw=None):
    """The trace through ``svc``: an insert and a delete every
    ``mutate_every`` requests, a drain every ``drain_every``, the
    keywords ``submit_kw(i)`` on request i; returns the tickets."""
    rng = np.random.default_rng(7)
    tickets = []
    for i, (pred, payload) in enumerate(trace):
        kw = submit_kw(i) if submit_kw else {}
        tickets.append(svc.submit("d", pred, payload, **kw))
        if (i + 1) % mutate_every == 0:
            qi = int(rng.integers(len(Q)))
            svc.insert("d", Q.verts[qi, : Q.nverts[qi]] * 0.8 + 0.1)
            svc.delete("d", int(rng.integers(len(svc.dataset("d")))))
        if (i + 1) % drain_every == 0:
            svc.drain()
    svc.drain()
    return tickets


def _pair_set(pairs) -> set:
    """The pairs as a set: a batch probes the warm MBR index, whose grid
    orders candidates unlike a one-request plan's MBR join."""
    return set(map(tuple, np.asarray(pairs).tolist()))


def _same_tickets(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a.wait(5.0), b.wait(5.0)
        assert a.pairs.dtype == b.pairs.dtype
        np.testing.assert_array_equal(a.pairs, b.pairs)
        for k in COUNTS:
            assert a.stats[k] == b.stats[k], k
        assert a.stats["extra"].get("plan") == b.stats["extra"].get("plan")
        assert a.stats["extra"]["batched_requests"] == \
            b.stats["extra"]["batched_requests"]


@pytest.mark.parametrize("plan_mode,port_mode", [
    ("static", "staged"), ("static", "fused"), ("adaptive", "staged")])
def test_trace_equals_reference(data, plan_mode, port_mode):
    """A seeded trace of every predicate, with mutations between drains:
    the tickets' pair arrays, the service and cache stats and the latency
    count equal the reference's."""
    _, Q0, _, Q = data
    ours, ref = _services(data, plan_mode=plan_mode, replan_after=2,
                          port_pipeline_mode=port_mode)
    trace = serve_join.make_trace(np.random.default_rng(3), Q, 48)
    rtrace = r_serve_join.make_trace(np.random.default_rng(3), Q0, 48)
    for (p, a), (rp, b) in zip(trace, rtrace):
        assert p == rp and np.array_equal(np.asarray(a), np.asarray(b))
    got = _drive(ours, Q, trace, mutate_every=6, drain_every=8)
    want = _drive(ref, Q0, rtrace, mutate_every=6, drain_every=8)
    _same_tickets(got, want)
    assert sum(len(t.pairs) for t in want) > 40
    assert ours.stats == ref.stats and ours.cache.stats == ref.cache.stats
    if plan_mode == "adaptive":
        assert ours.stats["replans"] >= 4
    lat = ours.latency_stats()
    assert lat["n"] == len(trace) and lat["p99_s"] >= lat["p50_s"] >= 0
    assert set(lat["stage_times"]) == set(ref.latency_stats()["stage_times"])


def test_microbatch_matches_per_request(data):
    """Each ticket holds what a one-request plan over the dataset returns
    (the reference's ``test_microbatch_matches_per_request``)."""
    _, _, R, Q = data
    svc = JoinService(method="april", n_order=N_ORDER, device="cpu")
    svc.register_dataset("d", R)
    tickets = {p: [svc.submit("d", p, Q.verts[i, : Q.nverts[i]])
                   for i in range(8)]
               for p in ("selection", "intersects", "within")}
    assert svc.drain() == 24 and svc.stats["batches"] == 3
    for p, ts in tickets.items():
        for i, t in enumerate(ts):
            one = PolygonDataset(name="q", verts=Q.verts[i: i + 1],
                                 nverts=Q.nverts[i: i + 1])
            want, _ = JoinPlan(R, one, n_order=N_ORDER,
                               device="cpu").execute(p)
            assert _pair_set(t.wait(5.0).pairs) == _pair_set(want)
            assert t.stats["extra"]["batched_requests"] == 8


def test_small_budget_hits_and_evictions_equal_reference(data):
    """Requests rotating over three orders under a budget below two
    stores: the cache's hits, misses and evictions equal the reference's,
    and an evicted store's device copies are released."""
    _, Q0, _, Q = data
    budget = int(1.5 * get_filter("april").build(data[2], n_order=N_ORDER
                                                 ).size_bytes())
    ours, ref = _services(data, cache_bytes=budget)
    trace = [("selection", Q.verts[i % 8, : Q.nverts[i % 8]])
             for i in range(18)]
    rtrace = [("selection", Q0.verts[i % 8, : Q0.nverts[i % 8]])
              for i in range(18)]

    def order(i):
        return {"n_order": N_ORDER + (i // 3) % 3}

    got = _drive(ours, Q, trace, 5, 3, submit_kw=order)
    want = _drive(ref, Q0, rtrace, 5, 3, submit_kw=order)
    _same_tickets(got, want)
    assert ours.cache.stats == ref.cache.stats
    assert ours.cache.stats["evictions"] >= 4
    # an evicted store releases its device copies and keeps its host ones
    svc = JoinService(n_order=N_ORDER, device="cpu", cache_bytes=budget)
    svc.register_dataset("d", data[2])
    svc.submit("d", "intersects", Q.verts[0, : Q.nverts[0]])
    svc.drain()
    evicted = svc.warm_store("d")
    lists = evicted.meta["interval_lists"]
    lists["F"].last_keys("cpu")
    assert lists["A"]._device and lists["F"]._keys
    svc.warm_store("d", n_order=N_ORDER + 2)
    assert ("d", "april", N_ORDER) not in svc.cache
    assert not lists["A"]._device and not lists["F"]._keys
    assert lists["F"]._host_keys is not None       # host arrays stay


def test_window_and_submission_validation(data):
    _, _, R, Q = data
    ours, ref = _services(data, method="ri")
    t, rt = (s.submit("d", "window", (0.2, 0.3, 0.7, 0.8))
             for s in (ours, ref))
    ours.drain(), ref.drain()
    assert len(rt.wait(5.0).pairs) > 0
    np.testing.assert_array_equal(t.wait(5.0).pairs, rt.pairs)
    rect = np.array([[0.2, 0.3], [0.7, 0.3], [0.7, 0.8], [0.2, 0.8]])
    want, _ = JoinPlan(R, PolygonDataset("w", rect[None], np.array([4])),
                       filter="ri", n_order=N_ORDER,
                       device="cpu").execute("selection")
    assert _pair_set(t.pairs) == _pair_set(want)
    for svc in (ours, ref):
        with pytest.raises(ValueError, match="unknown predicate"):
            svc.submit("d", "crosses", Q.verts[0, : Q.nverts[0]])
        with pytest.raises(KeyError, match="unknown dataset"):
            svc.submit("nope", "selection", Q.verts[0, : Q.nverts[0]])
        with pytest.raises(ValueError, match="already registered"):
            svc.register_dataset("d", R)
        with pytest.raises(IndexError, match="out of range"):
            svc.delete("d", 10_000)
    with pytest.raises(ValueError, match="pipeline_mode"):
        JoinService(device="cpu", pipeline_mode="bogus")
    with pytest.raises(ValueError, match="plan_mode"):
        JoinService(device="cpu", plan_mode="bogus")
    with pytest.raises(ValueError, match="budget_bytes"):
        StoreCache(budget_bytes=0)


def test_background_worker_resolves_tickets(data):
    """The worker resolves every ticket, and a ``record_joins`` block
    opened on this thread holds the kernel inputs of the worker's joins."""
    _, _, R, Q = data
    svc = JoinService(n_order=N_ORDER, window_s=0.01, device="cpu")
    svc.register_dataset("d", R)
    with join.record_joins() as joins:
        svc.start()
        svc.start()              # a second start is a no-op
        try:
            tickets = [svc.submit("d", "selection",
                                  Q.verts[i, : Q.nverts[i]])
                       for i in range(6)]
            for t in tickets:
                assert t.wait(10.0).pairs is not None
        finally:
            svc.stop()
    svc.stop()                   # so is a second stop
    assert svc.stats["batched_requests"] == 6
    assert joins and all(name == "interval_overlap" for name, _ in joins)


def test_worker_failure_fails_its_tickets(data, monkeypatch):
    """A group that raises in the worker is not swallowed: the tickets it
    leaves unresolved raise on ``wait``, ``stop`` raises the error, and so
    does a later ``submit``."""
    _, _, R, Q = data
    svc = JoinService(n_order=N_ORDER, window_s=0.01, device="cpu")
    svc.register_dataset("d", R)

    def broken(*a, **k):
        raise RuntimeError("group failed")

    monkeypatch.setattr(svc, "_run_group", broken)
    svc.start()
    t = svc.submit("d", "selection", Q.verts[0, : Q.nverts[0]])
    with pytest.raises(RuntimeError, match="join request failed") as err:
        t.wait(10.0)
    assert "group failed" in str(err.value.__cause__)
    with pytest.raises(RuntimeError, match="worker failed"):
        svc.stop()
    with pytest.raises(RuntimeError, match="worker failed"):
        svc.submit("d", "selection", Q.verts[0, : Q.nverts[0]])
    # a synchronous drain raises the group's error itself
    svc2 = JoinService(n_order=N_ORDER, device="cpu")
    svc2.register_dataset("d", R)
    monkeypatch.setattr(svc2, "_run_group", broken)
    t2 = svc2.submit("d", "within", Q.verts[1, : Q.nverts[1]])
    with pytest.raises(RuntimeError, match="group failed"):
        svc2.drain()
    with pytest.raises(RuntimeError, match="join request failed"):
        t2.wait(0.1)


class _OrderedLock:
    """A lock that records, per thread, whether it is held, and checks
    on every acquire of ``outer`` that ``inner`` is not held (DESIGN.md
    §11: ``_exec_lock`` outer, ``_lock`` inner, never the reverse)."""

    def __init__(self, lock, held, inner=None):
        self._lock, self._held, self._inner = lock, held, inner
        self.violations = []

    def acquire(self, *a, **k):
        if self._inner is not None and getattr(self._held, "inner", 0):
            self.violations.append(threading.current_thread().name)
        ok = self._lock.acquire(*a, **k)
        if ok and self._inner is None:
            self._held.inner = getattr(self._held, "inner", 0) + 1
        return ok

    def release(self):
        if self._inner is None:
            self._held.inner -= 1
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


def test_hammer_submit_patch_evict(data):
    """The reference's concurrency hammer at reduced counts (3 threads x
    8 rounds, where it runs 4 x 12): callers submit, insert, delete, warm
    other orders and read the cache while the worker drains under a small
    budget; every ticket resolves, the counters add up, and no thread
    takes ``_exec_lock`` while holding ``_lock``."""
    n_threads, n_rounds = 3, 8
    _, _, R, Q = data
    svc = JoinService(cache_bytes=64 << 10, window_s=0.001, n_order=5,
                      device="cpu")
    held = threading.local()
    svc._lock = _OrderedLock(svc._lock, held)
    svc._exec_lock = _OrderedLock(svc._exec_lock, held, inner=svc._lock)
    svc.register_dataset("T1", R)
    svc.start()
    errors, tickets, inserted = [], [], []
    guard = threading.Lock()

    def caller(tid: int):
        rng = np.random.default_rng(100 + tid)
        try:
            for r in range(n_rounds):
                i = int(rng.integers(len(Q)))
                t = svc.submit("T1", "selection", Q.verts[i, : Q.nverts[i]])
                with guard:
                    tickets.append(t)
                if r % 3 == 0:
                    c = rng.random(2) * 0.9 + 0.05
                    sq = np.array([c, c + [0.02, 0], c + 0.02,
                                   c + [0, 0.02]])
                    new_id = svc.insert("T1", sq)
                    with guard:
                        inserted.append(new_id)
                if r % 4 == 1:
                    svc.warm_store("T1", n_order=5 + (r % 3))
                if r % 5 == 2:
                    svc.delete("T1", int(rng.integers(len(R))))
                svc.latency_stats()
                for _, approx in svc.cache.items():
                    assert approx.size_bytes() >= 0
        except BaseException as exc:  # noqa: BLE001 - reraised below
            errors.append(exc)

    threads = [threading.Thread(target=caller, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    svc.stop()
    assert not errors, errors
    for t in tickets:
        t.wait(10.0)
        assert t.pairs is not None and t.pairs.shape[1] == 2
    assert svc.stats["requests"] == n_threads * n_rounds
    assert svc.stats["batched_requests"] == svc.stats["requests"]
    assert svc.stats["inserts"] == len(inserted)
    assert svc.stats["deletes"] == n_threads * sum(
        r % 5 == 2 for r in range(n_rounds))
    assert svc.latency_stats()["n"] == svc.stats["requests"]
    assert svc._exec_lock.violations == []
    expect = sum(a.size_bytes() for _, a in svc.cache.items())
    assert svc.cache.stats["resident_bytes"] == expect


def test_store_cache_byte_accounting_under_contention():
    """The reference's cache contention test at reduced counts (3 threads
    x 120 operations, where it runs 4 x 200)."""
    cache = StoreCache(48 << 10)
    D = make_dataset("T3", seed=73, count=12)
    protos = [get_filter("april").build(D, n_order=n) for n in (4, 5, 6)]
    errors = []

    def worker(tid: int):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(120):
                key = (f"d{int(rng.integers(6))}", "april",
                       int(rng.integers(3)))
                op = int(rng.integers(4))
                if op == 0:
                    cache.put(key, protos[key[2]])
                elif op == 1:
                    cache.get(key)
                elif op == 2:
                    cache.pop(key)
                else:
                    cache.resize(key)
                assert cache.stats["resident_bytes"] >= 0
        except BaseException as exc:  # noqa: BLE001 - reraised below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errors, errors
    expect = sum(a.size_bytes() for _, a in cache.items())
    assert cache.stats["resident_bytes"] == expect
    assert len(cache) == len(cache.items())


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_format_equals_reference(tmp_path):
    """Leaf names, manifest and files as the reference writes them; each
    manager restores what the other saved; crc32, LATEST and keep-last-K
    behave alike."""
    tree = {"b": [np.arange(3), (np.ones((2, 2), np.float32), None)],
            "a": {"x": torch.arange(4, dtype=torch.int32), "y": 2.5}}
    rtree = {"b": [np.arange(3), (np.ones((2, 2), np.float32), None)],
             "a": {"x": np.arange(4, dtype=np.int32), "y": 2.5}}
    flat = checkpoint.tree_to_flat(tree)
    rflat = r_checkpoint.tree_to_flat(rtree)
    assert list(flat) == list(rflat)
    for k in flat:
        assert flat[k].dtype == rflat[k].dtype
        np.testing.assert_array_equal(flat[k], rflat[k])
    back = checkpoint.flat_to_tree(flat, tree)
    assert torch.equal(back["a"]["x"], tree["a"]["x"])
    assert back["b"][1][1] is None and isinstance(back["b"][1], tuple)
    ours = CheckpointManager(str(tmp_path / "ours"), keep=2,
                             async_save=False)
    for step in (1, 2, 3):
        ours.save(step, tree, extra={"step": step})
    assert ours.all_steps() == [2, 3] and ours.latest_step() == 3
    theirs = r_checkpoint.CheckpointManager(str(tmp_path / "ours"))
    step, got, extra = theirs.restore()
    assert step == 3 and extra == {"step": 3}
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])
    r_checkpoint.CheckpointManager(str(tmp_path / "ref"),
                                   async_save=False).save(5, rtree)
    step, got, _ = CheckpointManager(str(tmp_path / "ref")).restore()
    assert step == 5 and list(got) == list(rflat)
    with open(tmp_path / "ours" / "step_3" / "manifest.json") as f:
        manifest = json.load(f)
    manifest["leaves"]["b/0"]["crc32"] += 1
    with open(tmp_path / "ours" / "step_3" / "manifest.json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="checksum"):
        ours.restore(3)
    assert CheckpointManager(str(tmp_path / "none")).restore() is None


def _mutated_service(svc, Q, method):
    svc.warm_store("d", method)
    svc.insert("d", Q.verts[0, : Q.nverts[0]] * 0.8 + 0.1)
    svc.delete("d", 5)
    svc.submit("d", "within", Q.verts[2, : Q.nverts[2]], method=method)
    svc.drain()
    svc.insert("d", Q.verts[3, : Q.nverts[3]] * 0.5 + 0.2)


@pytest.mark.parametrize("method", ["april", "ri"])
@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_checkpoint_carries_state_across(data, tmp_path, method,
                                         direction):
    """A service checkpoint written by one package restores into the
    other; the restored service has the store warm at its saved position
    in the log, replays the mutations it missed, and answers every
    request as the service that saved it does."""
    _, Q0, _, Q = data
    ours, ref = _services(data, method=method)
    _mutated_service(ours, Q, method)
    _mutated_service(ref, Q0, method)
    src, mgr_cls, restore = (
        (ref, r_checkpoint.CheckpointManager,
         lambda m: JoinService.restore_checkpoint(m, device="cpu"))
        if direction == "reference-to-port" else
        (ours, CheckpointManager, RJoinService.restore_checkpoint))
    mgr = mgr_cls(str(tmp_path), async_save=False)
    src.save_checkpoint(mgr, step=4)
    restored = restore(mgr)
    key = ("d", method, N_ORDER)
    assert key in restored.cache
    assert restored.cache.get(key).meta["mutation_seq"] == 2
    assert restored.dataset("d").verts.tobytes() == \
        src.dataset("d").verts.tobytes()
    for svc in (restored, src):
        for i in range(6):
            svc.submit("d", ("selection", "within")[i % 2],
                       Q.verts[i, : Q.nverts[i]])
        svc.drain()
    assert restored.cache.get(key).meta["mutation_seq"] == 3
    got = [restored, src]
    want = {}
    for svc in got:
        tickets = [svc.submit("d", p, Q.verts[i, : Q.nverts[i]])
                   for i in range(8) for p in ("selection", "intersects",
                                               "within")]
        svc.drain()
        want[id(svc)] = [t.wait(5.0).pairs for t in tickets]
    assert sum(len(p) for p in want[id(src)]) > 0
    for a, b in zip(want[id(restored)], want[id(src)]):
        np.testing.assert_array_equal(a, b)


def test_restore_checkpoint_none_when_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert JoinService.restore_checkpoint(mgr, device="cpu") is None


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan_mode", ["static", "adaptive"])
def test_run_serve_equals_reference(plan_mode, tmp_path):
    """``run_serve`` with the caller's thread draining (no timing in the
    batches) returns the reference's result count, service counters and
    cache stats; with ``--ckpt-dir`` a second run resumes from the
    first's checkpoint as the reference's does."""
    kw = dict(count=120, n_queries=30, n_requests=40, mutate_every=10,
              plan_mode=plan_mode, background=False)
    got = serve_join.run_serve(device="cpu", **kw)
    want = r_serve_join.run_serve(**kw)
    for k in ("results_total", "service", "cache", "n_requests"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got["latency"]["n"] == 40
    if plan_mode == "adaptive":
        assert got["service"]["replans"] >= 2
        return
    for run, d in ((serve_join.run_serve, "ours"),
                   (r_serve_join.run_serve, "ref")):
        opts = dict(kw, ckpt_dir=str(tmp_path / d), ckpt_every=20)
        if run is serve_join.run_serve:
            opts["device"] = "cpu"
        run(**opts)
        again = run(**opts)
        if d == "ours":
            got = again
        else:
            want = again
    assert got["results_total"] == want["results_total"]
    assert got["cache"] == want["cache"]
