"""The port's serving tier (``repro_torch/serve``) against the JAX
package's (``repro/serve``) on the CPU.

Every scenario of the reference's ``tests/test_serve.py`` —
``ShardSpec``, the sharded server against the core server, the history
ring, atomic publish, ``TestIngestPipeline`` and ``TestIslandDeathMidPush``
— is written once against a namespace and run through both packages; the
port must return what the JAX package returns: equal counters, lags,
versions and exceptions, and the same published parameters.

Tolerances: K1's arithmetic is elementwise f32 with the same f32 scalars
in both packages, so parameters are held at rtol 1e-6 / atol 1e-7 (the
reference's jitted apply may contract a multiply-add that the port's
plain K1 rounds twice); the port's sharded server against its own core
server bit for bit; ``v_norm`` (a sum of squares reduced in another
order) at the reference's rel 1e-4. The concurrent-reader test joins its
thread with a timeout."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fault.monitor as jmon  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.core.server import AsyncParameterServer as JaxCore  # noqa: E402
import repro_torch.fault.monitor as tmon  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.serve.server as tserver  # noqa: E402
from repro_torch.core.server import AsyncParameterServer as TorchCore  # noqa: E402
from repro_torch.kernels.fused_update.ops import tree_leaves, tree_map  # noqa: E402


class NS:
    """One package's serving tier behind one set of names."""

    def __init__(self, port: bool):
        self.port = port
        self.mod = tserve if port else jserve
        self.FleetMonitor = (tmon if port else jmon).FleetMonitor
        for name in ("IngestPipeline", "PushQueue", "ServeClient",
                     "ShardSpec", "resolve_codec"):
            setattr(self, name, getattr(self.mod, name))

    def arr(self, x, dtype=np.float32):
        x = np.asarray(x, dtype)
        return torch.from_numpy(x.copy()) if self.port else jnp.asarray(x)

    def np(self, x):
        return x.numpy() if self.port else np.asarray(x)

    def server(self, params, **kw):
        if self.port:
            kw["device"] = "cpu"
        return self.mod.ShardedAsyncParameterServer(params, eta=0.05,
                                                    beta=0.9, **kw)

    def core(self, params, **kw):
        if self.port:
            return TorchCore(params, eta=0.05, beta=0.9, device="cpu", **kw)
        return JaxCore(params, eta=0.05, beta=0.9, **kw)

    def tiny(self, n=13, seed=0):
        rng = np.random.default_rng(seed)
        return {"w": self.arr(rng.normal(0, 1, (2, 5))),
                "b": self.arr(rng.normal(0, 1, n - 10))}

    def flat_of(self, server):
        shards, version = server.snapshot_flat()
        return self.np(server.spec.join(shards)), version

    def leaves(self, tree):
        return [self.np(l) for l in (tree_leaves(tree) if self.port
                                     else jax.tree.leaves(tree))]


PORT, JAX = NS(True), NS(False)


def _agree(fn, *args):
    """Run ``fn`` through both packages and hold the port's observations
    to the JAX package's."""
    ours, theirs = fn(PORT, *args), fn(JAX, *args)
    _compare(ours, theirs)
    return ours


def _compare(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _compare(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _compare(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-4, abs=1e-7)
    else:
        assert a == b


def _raises(fn, exc, match):
    for ns in (PORT, JAX):
        with pytest.raises(exc, match=match):
            fn(ns)


# ---------------------------------------------------------------------------
# ShardSpec
# ---------------------------------------------------------------------------
def test_shardspec_flatten_unflatten_mixed_dtypes():
    def run(ns):
        params = {"a": ns.arr(np.arange(6).reshape(2, 3)),
                  "b": ns.arr([1, 2, 3], np.int32),
                  "c": ns.arr(7.0)}
        spec = ns.ShardSpec(params, 3)
        flat = spec.flatten(params)
        out = spec.unflatten(flat)
        assert str(out["b"].dtype).endswith("int32")
        return {"flat": ns.np(flat), "leaves": ns.leaves(out),
                "total": spec.total, "bounds": spec.boundaries}
    _agree(run)


@pytest.mark.parametrize("n,shards", [(10, 3), (11, 4), (2, 5), (13, 1)])
def test_shardspec_boundaries_split_join(n, shards):
    def run(ns):
        spec = ns.ShardSpec({"w": ns.arr(np.zeros(n))}, shards)
        flat = ns.arr(np.arange(n))
        pieces = spec.split(flat)
        assert sum(spec.shard_size(i) for i in range(shards)) == spec.total
        return {"bounds": spec.boundaries,
                "sizes": [spec.shard_size(i) for i in range(shards)],
                "pieces": [ns.np(p) for p in pieces],
                "joined": ns.np(spec.join(pieces)),
                "zeros": [ns.np(z) for z in spec.zeros_shards()]}
    out = _agree(run)
    if shards > n:
        assert 0 in out["sizes"]


def test_shardspec_rejects_bad_inputs_like_jax():
    _raises(lambda ns: ns.ShardSpec({"w": ns.arr(np.zeros(4))}, 0),
            ValueError, "n_shards")
    _raises(lambda ns: ns.ShardSpec({}, 2), ValueError, "empty")
    _raises(lambda ns: ns.ShardSpec({"w": ns.arr(np.zeros(4))}, 2)
            .unflatten(ns.arr(np.zeros(3))), ValueError, "shape")
    _raises(lambda ns: ns.ShardSpec({"w": ns.arr(np.zeros(4))}, 2)
            .join([ns.arr(np.zeros(4))]), ValueError, "slices")
    _raises(lambda ns: ns.ShardSpec({"w": ns.arr(np.zeros(4))}, 2)
            .flatten({"w": ns.arr(np.zeros(4)), "v": ns.arr(np.zeros(1))}),
            ValueError, "leaves")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tserve.ShardSpec({"w": torch.zeros(4)}, 2, mesh=object())


# ---------------------------------------------------------------------------
# The sharded server against the core server, and against JAX's
# ---------------------------------------------------------------------------
def _stream(ns, aggregation, n_shards):
    params = ns.tiny()
    core = ns.core(params, aggregation=aggregation)
    shd = ns.server(params, aggregation=aggregation, n_shards=n_shards)
    rng = np.random.default_rng(1)
    pulled, results = {}, []
    for step in range(12):
        cid = step % 3
        if cid not in pulled:
            p_c, vc = core.pull(cid)
            _, vs = shd.pull(cid)
            assert vc == vs
            noise = [rng.normal(0, 0.1, l.shape).astype(np.float32)
                     for l in ns.leaves(p_c)]
            it = iter(noise)
            if ns.port:
                pulled[cid] = tree_map(
                    lambda x: x + torch.from_numpy(next(it)), p_c)
            else:
                pulled[cid] = jax.tree.map(
                    lambda x: x + jnp.asarray(next(it)), p_c)
        if step % 2 == 1:       # stale pushes: half the pulls linger
            new = pulled.pop(cid)
            rc, rs = core.push(cid, new), shd.push(cid, new)
            assert (rc.lag, rc.version) == (rs.lag, rs.version)
            assert rc.applied_weight == pytest.approx(rs.applied_weight,
                                                      rel=1e-5, abs=1e-7)
            results.append((rs.lag, rs.version, rs.applied_weight,
                            float(rs.gap_estimate)))
    shd.assert_consistent()
    for a, b in zip(ns.leaves(core.params), ns.leaves(shd.params)):
        if ns.port:     # the same elementwise K1, shard by shard
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert shd.v_norm == pytest.approx(float(core.v_norm), rel=1e-4,
                                       abs=1e-7)
    return {"results": results, "params": ns.leaves(shd.params),
            "v_norm": float(shd.v_norm), "version": shd.version}


@pytest.mark.parametrize("aggregation",
                         ["replace", "fedasync_poly", "gap_aware"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_matches_core_and_jax(aggregation, n_shards):
    _agree(_stream, aggregation, n_shards)


def test_one_k1_launch_per_shard_per_push(monkeypatch):
    calls = []
    real = tserver.fused_apply_flat

    def counted(cur, *a, **k):
        calls.append(cur.numel())
        return real(cur, *a, **k)

    monkeypatch.setattr(tserver, "fused_apply_flat", counted)
    shd = PORT.server(PORT.tiny(), n_shards=4)
    for k in range(3):
        p, _ = shd.pull(0)
        shd.push(0, tree_map(lambda x: x + 1.0, p))
    assert calls == [4, 3, 3, 3] * 3


def test_lag_estimate_counts_concurrent_tasks():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=2)
        shd.pull(0)
        shd.pull(1)
        return [shd.lag_estimate(0), shd.lag_estimate(9)]
    assert _agree(run) == [1, 2]


def test_params_setter_resplits_and_republishes():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=3)
        p, _ = shd.pull(0)
        shd.push(0, p)
        shd.params = {"w": ns.arr(np.full((2, 5), 5.0)),
                      "b": ns.arr(np.full(3, 5.0))}
        flat, version = ns.flat_of(shd)
        shd.assert_consistent()
        return {"flat": flat, "version": version}
    out = _agree(run)
    assert out["version"] == 1        # restore does not bump
    np.testing.assert_array_equal(out["flat"], 5.0)


def test_history_ring_serves_old_bases_then_ages_out():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=2, history_depth=3)
        snaps = {0: ns.flat_of(shd)[0]}
        for k in range(5):
            p, _ = shd.pull(0)
            shd.push(0, {key: v + 1.0 for key, v in p.items()})
            snaps[k + 1] = ns.flat_of(shd)[0]
        for v in (3, 4, 5):
            got = np.concatenate([ns.np(shd.base_shard(v, i))
                                  for i in range(2)])
            np.testing.assert_array_equal(got, snaps[v])
        return {"miss": shd.base_shard(0, 0) is None,
                "ring_misses": shd.ring_misses, "snaps": list(snaps.values())}
    out = _agree(run)
    assert out["miss"] and out["ring_misses"] == 1


def test_rejects_wrong_slice_count_and_bad_history_depth():
    _raises(lambda ns: ns.server(ns.tiny(), n_shards=2).push_flat(
        0, [ns.arr(np.zeros(13))]), ValueError, "slices")
    _raises(lambda ns: ns.server(ns.tiny(), history_depth=0), ValueError,
            "history_depth")


def test_published_shards_are_never_written():
    """A pulled snapshot stays as it was after later pushes: K1 allocates
    its outputs and nothing writes a published shard in place."""
    shd = PORT.server(PORT.tiny(), n_shards=3)
    shards, _ = shd.pull_flat(0)
    kept = [s.clone() for s in shards]
    for k in range(4):
        p, _ = shd.pull(0)
        shd.push(0, tree_map(lambda x: x * 2.0 + 1.0, p))
    for s, c in zip(shards, kept):
        assert torch.equal(s, c)


# ---------------------------------------------------------------------------
# Atomic publish
# ---------------------------------------------------------------------------
def test_reader_never_sees_partial_push_concurrently():
    shd = PORT.server({"w": torch.zeros(64)}, n_shards=4)
    errors = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            flat, version = PORT.flat_of(shd)
            if not np.all(flat == flat[0]):
                errors.append(("torn", flat.copy(), version))
                return
            if flat[0] != float(version):
                errors.append(("mismatch", float(flat[0]), version))
                return

    t = threading.Thread(target=reader)
    t.start()
    try:
        for k in range(50):
            shd.pull(0)
            shd.push(0, {"w": torch.full((64,), float(k + 1))})
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert errors == []
    shd.assert_consistent()


def test_staged_partial_push_is_invisible():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=3)
        pipe = ns.IngestPipeline(shd)
        client = ns.ServeClient(0, pipe)
        before, v0 = ns.flat_of(shd)
        client.pull()
        client.push(ns.arr(before + 1.0), slot=0, shards=[0, 1])
        pipe.drain()
        after, v1 = ns.flat_of(shd)
        np.testing.assert_array_equal(after, before)
        return {"pending": pipe.pending_pushes, "v": (v0, v1)}
    assert _agree(run) == {"pending": 1, "v": (0, 0)}


# ---------------------------------------------------------------------------
# TestIngestPipeline, as JAX-vs-port parity
# ---------------------------------------------------------------------------
def _observe(ns, shd, pipe):
    flat, version = ns.flat_of(shd)
    return {"flat": flat, "version": version,
            "stats": pipe.stats.as_dict(), "pending": pipe.pending_pushes,
            "parked": sorted(pipe.parked_clients)}


def test_ingest_happy_path_commits_and_records_latency():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=3)
        pipe = ns.IngestPipeline(shd)
        clients = [ns.ServeClient(i, pipe) for i in range(4)]
        for t in range(3):
            for c in clients:
                base, _ = c.pull()
                c.push(ns.arr(ns.np(base) + 0.5), slot=t)
            pipe.drain()
        assert len(pipe.latencies) == 12
        assert all(l >= 0 for l in pipe.latencies)
        shd.assert_consistent()
        return _observe(ns, shd, pipe)
    out = _agree(run)
    assert out["stats"]["applied"] == 12 and out["version"] == 12


def test_ingest_backpressure_rejects_when_full():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=4)
        pipe = ns.IngestPipeline(shd, capacity=6)
        c0, c1 = ns.ServeClient(0, pipe), ns.ServeClient(1, pipe)
        base0, _ = c0.pull()
        base1, _ = c1.pull()
        obs = [c0.push(ns.arr(ns.np(base0) + 1), slot=0),
               c1.push(ns.arr(ns.np(base1) + 1), slot=0)]
        pipe.drain()
        obs.append(_observe(ns, shd, pipe))
        c1.resume_push(0, ns.arr(ns.np(base1) + 1), slot=1)
        pipe.drain()
        obs.append(_observe(ns, shd, pipe))
        return obs
    out = _agree(run)
    assert out[0][1] == 4 and out[1][1] == 2
    assert out[2]["stats"]["applied"] == 1 and out[2]["pending"] == 1
    assert out[3]["stats"]["applied"] == 2 and out[3]["pending"] == 0


def test_ingest_rejects_bad_capacity_and_unknown_codec():
    _raises(lambda ns: ns.PushQueue(0), ValueError, "capacity")
    _raises(lambda ns: ns.resolve_codec("gzip"), ValueError, "codec")
    _raises(lambda ns: ns.resolve_codec(3), ValueError, "codec")
    _raises(lambda ns: ns.mod.TopKDeltaCodec(ratio=0.0), ValueError,
            "ratio")
    assert tserve.registered_codecs() == jserve.registered_codecs()


def test_ingest_int8_push_roundtrip_fidelity():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=3)
        pipe = ns.IngestPipeline(shd, codec="int8")
        c = ns.ServeClient(0, pipe)
        base, _ = c.pull()
        target = ns.np(base) + np.linspace(-2, 2, 13, dtype=np.float32)
        c.push(ns.arr(target), slot=0)
        pipe.drain()
        got, _ = ns.flat_of(shd)
        for i in range(3):
            sl = shd.spec.shard_slice(i)
            scale = max(np.abs(target[sl]).max() / 127.0, 1e-12)
            assert np.abs(got[sl] - target[sl]).max() <= scale * 0.5 + 1e-6
        return _observe(ns, shd, pipe)
    assert _agree(run)["version"] == 1


def test_ingest_topk_delta_stream_converges_to_uncompressed_fixed_point():
    target = np.random.default_rng(3).normal(0, 1, 48).astype(np.float32)

    def run(ns, codec, steps=300):
        shd = ns.server({"w": ns.arr(np.zeros(48))}, n_shards=4)
        pipe = ns.IngestPipeline(shd, codec=codec)
        c = ns.ServeClient(0, pipe)
        for t in range(steps):
            base, _ = c.pull()
            b = ns.np(base)
            c.push(ns.arr(b + np.float32(0.05) * (target - b)), slot=t)
            pipe.drain()
        return {"flat": ns.flat_of(shd)[0], "stats": pipe.stats.as_dict()}

    ref = _agree(run, None)
    np.testing.assert_allclose(ref["flat"], target, atol=1e-3)
    compressed = _agree(run, "topk")
    np.testing.assert_allclose(compressed["flat"], target, atol=1e-2)


def test_ingest_topk_ring_miss_falls_back_and_counts():
    def run(ns):
        shd = ns.server(ns.tiny(), n_shards=2, history_depth=1)
        pipe = ns.IngestPipeline(shd, codec="topk")
        stale, fresh = ns.ServeClient(0, pipe), ns.ServeClient(1, pipe)
        stale.pull()
        for t in range(3):
            base, _ = fresh.pull()
            fresh.push(ns.arr(ns.np(base) + 0.1), slot=t)
            pipe.drain()
        stale.push(ns.arr(ns.flat_of(shd)[0] + 0.1), slot=3)
        pipe.drain()
        obs = _observe(ns, shd, pipe)
        # every delta is ~0.1: equal magnitudes, where the libraries' top-k
        # may keep different entries, so only the counters are compared
        del obs["flat"]
        return obs
    out = _agree(run)
    assert out["stats"]["ring_misses"] == 2 and out["stats"]["applied"] == 4


# ---------------------------------------------------------------------------
# TestIslandDeathMidPush, as JAX-vs-port parity
# ---------------------------------------------------------------------------
def _make(ns, timeout=3, n_shards=3):
    shd = ns.server(ns.tiny(), n_shards=n_shards)
    return shd, ns.IngestPipeline(
        shd, monitor=ns.FleetMonitor(timeout_slots=timeout))


def test_push_survives_death_applied_exactly_once():
    def run(ns):
        shd, pipe = _make(ns)
        c = ns.ServeClient(7, pipe)
        base, _ = c.pull()
        target = ns.arr(ns.np(base) + 1.0)
        pid, _ = c.push(target, slot=0, shards=[0, 1])     # dies here
        pipe.drain()
        obs = [sorted(pipe.sweep(10)), 7 in pipe.monitor.active,
               _observe(ns, shd, pipe)]
        c.resume_push(pid, target, slot=11)                 # recovery
        pipe.drain()
        obs += [7 in pipe.monitor.active, _observe(ns, shd, pipe)]
        np.testing.assert_allclose(obs[-1]["flat"], ns.np(target),
                                   rtol=1e-6)
        shd.assert_consistent()
        return obs
    out = _agree(run)
    assert out[0] == [7] and not out[1] and out[3]
    assert out[2]["version"] == 0 and out[2]["parked"] == [7]
    assert out[4]["version"] == 1 and out[4]["stats"]["applied"] == 1
    assert out[4]["stats"]["reregistered"] == 1 and out[4]["parked"] == []


def test_queued_inflight_shards_are_requeued_not_lost():
    def run(ns):
        shd, pipe = _make(ns)
        c = ns.ServeClient(3, pipe)
        base, _ = c.pull()
        target = ns.arr(ns.np(base) + 2.0)
        pid, acc = c.push(target, slot=0)
        pipe.step(1)
        obs = [acc, sorted(pipe.sweep(8)), len(pipe.queue),
               _observe(ns, shd, pipe)]
        c.resume_push(pid, target, slot=9)      # nothing missing -> no-op
        obs.append(sorted(pipe.parked_clients))
        c.pull()
        c.push(ns.arr(ns.np(target) + 1.0), slot=9)
        pipe.drain()
        obs.append(_observe(ns, shd, pipe))
        shd.assert_consistent()
        return obs
    out = _agree(run)
    assert out[0] == 3 and out[1] == [3] and out[2] == 0
    assert out[3]["stats"]["parked_packets"] == 2 and out[4] == [3]
    assert out[5]["stats"]["requeued_packets"] == 2
    assert out[5]["stats"]["applied"] == 2 and out[5]["version"] == 2


def test_full_resend_after_commit_is_deduped():
    def run(ns):
        shd, pipe = _make(ns)
        c = ns.ServeClient(5, pipe)
        base, _ = c.pull()
        target = ns.arr(ns.np(base) + 1.0)
        pid, _ = c.push(target, slot=0)
        pipe.drain()
        c._sent[pid].clear()
        c.resume_push(pid, target, slot=1)
        pipe.drain()
        return _observe(ns, shd, pipe)
    out = _agree(run)
    assert out["stats"]["applied"] == 1 and out["stats"]["duplicates"] == 3
    assert out["version"] == 1


def test_monitor_cadence_counts_pushes_not_packets():
    def run(ns):
        shd, pipe = _make(ns, n_shards=3)
        c = ns.ServeClient(1, pipe)
        for t in range(3):
            base, _ = c.pull()
            c.push(ns.arr(ns.np(base) + 0.1), slot=t)
            pipe.drain()
        w = pipe.monitor.straggler.workers[1]
        return {"updates": w.updates, "ewma": w.ewma_interval,
                "obs": _observe(ns, shd, pipe)}
    assert _agree(run)["updates"] == 3
