"""The port's data-side schedulers and data pipeline held against the JAX
package's on the CPU: ``sched.data_balance`` (PSTS over sequences),
``sched.straggler`` (EWMA step times -> powers) and ``data/`` (document
stream, packing, global batches, the resumable pipeline). Both packages are
numpy host code and run the same operations, so every array is equal
exactly. Step times are inputs, given explicitly as the reference's tests
give them. The cases of ``tests/test_sched.py`` (data balance, straggler
monitor) and ``tests/test_substrate.py`` (data) run on the port as well.
"""

import _torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest

from repro import data as jdata
from repro.obs import Tracer as JTracer
from repro.sched import data_balance as jbal
from repro.sched import straggler as jstrag
from repro_torch import sched
from repro_torch.data import (
    DocStream,
    Pipeline,
    make_global_batch,
    pack_documents,
)
from repro_torch.obs import Tracer
from repro_torch.sched.data_balance import balance_sequences, sequence_work
from repro_torch.sched.straggler import StragglerMonitor


def _assert_balance_equal(got, want):
    np.testing.assert_array_equal(got.shard, want.shard)
    np.testing.assert_array_equal(got.shard_work, want.shard_work)
    np.testing.assert_array_equal(got.target_work, want.target_work)
    assert got.moved == want.moved
    assert got.max_over_target == want.max_over_target


def _monitors(**kw):
    return StragglerMonitor(**kw), jstrag.StragglerMonitor(**kw)


def _assert_monitor_equal(mon, jmon):
    np.testing.assert_array_equal(mon.powers(), jmon.powers())
    np.testing.assert_array_equal(mon.stragglers(), jmon.stragglers())
    np.testing.assert_array_equal(mon.alive, jmon.alive)


# ---------------------------------------------------------------------------
# data balance
# ---------------------------------------------------------------------------

def test_sequence_work_superlinear():
    lengths = np.array([1024, 2048, 4096])
    w = sequence_work(lengths)
    assert w[1] > 2 * w[0]          # quadratic term kicks in
    assert w[2] > 2 * w[1]
    np.testing.assert_array_equal(w, jbal.sequence_work(lengths))
    np.testing.assert_array_equal(
        sequence_work(lengths, quad_norm=1024.0, quad_weight=2.0),
        jbal.sequence_work(lengths, quad_norm=1024.0, quad_weight=2.0))


def test_balance_sequences_uniform_powers():
    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 4096, size=512)
    res = balance_sequences(lengths, dims=(2, 8))
    assert res.shard.shape == (512,)
    assert res.shard.max() < 16
    spread = res.shard_work.max() - res.shard_work.min()
    assert spread <= sequence_work(np.array([4096]))[0] * 2
    _assert_balance_equal(res, jbal.balance_sequences(lengths, dims=(2, 8)))


def test_balance_sequences_straggler_gets_less():
    rng = np.random.default_rng(1)
    lengths = rng.integers(64, 2048, size=800)
    powers = np.ones(8)
    powers[3] = 0.25                 # one slow host
    res = balance_sequences(lengths, dims=(8,), powers=powers)
    mean_other = np.delete(res.shard_work, 3).mean()
    assert res.shard_work[3] < 0.45 * mean_other
    _assert_balance_equal(
        res, jbal.balance_sequences(lengths, dims=(8,), powers=powers))


def test_balance_hierarchical_pods_first():
    rng = np.random.default_rng(2)
    lengths = rng.integers(64, 2048, size=600)
    init = rng.integers(0, 8, size=600)
    res = balance_sequences(lengths, dims=(2, 8), initial_shard=init)
    pod_work = res.shard_work.reshape(2, 8).sum(axis=1)
    assert abs(pod_work[0] - pod_work[1]) / pod_work.sum() < 0.05
    _assert_balance_equal(
        res, jbal.balance_sequences(lengths, dims=(2, 8),
                                    initial_shard=init))


@pytest.mark.parametrize("dims", [(4,), (2, 2, 3), (3, 5)])
def test_balance_sequences_equals_reference(dims):
    rng = np.random.default_rng(sum(dims))
    n = int(np.prod(dims))
    lengths = rng.integers(16, 8192, size=257)
    powers = rng.uniform(0.0, 2.0, n)
    powers[0] = 0.0                  # a dead host: the paper's virtual node
    init = rng.integers(0, n, size=257)
    kw = dict(powers=powers, initial_shard=init, quad_weight=1.0)
    _assert_balance_equal(balance_sequences(lengths, dims, **kw),
                          jbal.balance_sequences(lengths, dims, **kw))
    with pytest.raises(ValueError, match="powers shape"):
        balance_sequences(lengths, dims, powers=np.ones(n + 1))


def test_sched_exports_the_data_side_schedulers():
    assert sched.balance_sequences is balance_sequences
    assert sched.StragglerMonitor is StragglerMonitor
    assert sched.BalanceResult.__module__ == "repro_torch.sched.data_balance"


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_monitor_powers_track_speed():
    mon, jmon = _monitors(n_hosts=4)
    for _ in range(10):
        for m in (mon, jmon):
            m.update(np.array([1.0, 1.0, 2.0, 1.0]))  # host 2 is 2x slower
    tau = mon.powers()
    assert tau[2] < tau[0]
    assert tau[2] == pytest.approx(tau[0] / 2, rel=0.05)
    assert mon.stragglers().tolist() == [False, False, True, False]
    _assert_monitor_equal(mon, jmon)


def test_straggler_monitor_dead_host_is_virtual():
    mon, jmon = _monitors(n_hosts=3, heartbeat_limit=2)
    for _ in range(3):
        for m in (mon, jmon):
            m.update({0: 1.0, 1: 1.0})   # host 2 never reports
    assert not mon.alive[2]
    assert mon.powers()[2] == 0.0
    _assert_monitor_equal(mon, jmon)


def test_straggler_monitor_equals_reference_over_a_run():
    rng = np.random.default_rng(7)
    kw = dict(n_hosts=6, alpha=0.2, straggler_factor=1.3, heartbeat_limit=2)
    mon, jmon = _monitors(**kw)
    fresh = StragglerMonitor(**kw)
    np.testing.assert_array_equal(fresh.powers(), np.ones(6))  # no data yet
    assert not fresh.stragglers().any()
    for step in range(40):
        times = rng.uniform(0.5, 3.0, 6)
        if step % 3:
            report = {h: float(times[h]) for h in range(6)
                      if rng.random() > 0.3}
        else:
            report = times
        for m in (mon, jmon):
            m.update(report)
        _assert_monitor_equal(mon, jmon)


def test_straggler_monitor_records_decisions_on_the_tracer():
    tr, jtr = Tracer(), JTracer()
    mon = StragglerMonitor(n_hosts=2, tracer=tr)
    jmon = jstrag.StragglerMonitor(n_hosts=2, tracer=jtr)
    for _ in range(5):
        mon.update(np.array([1.0, 2.0]))
        jmon.update(np.array([1.0, 2.0]))
    # the latencies are wall-clock readings; the counts are equal
    assert tr.decision_stats()["estimate"]["n"] == \
        jtr.decision_stats()["estimate"]["n"] == 5


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_docstream_deterministic():
    s = DocStream(vocab_size=100, seed=7)
    a = s.doc(42)
    b = s.doc(42)
    assert np.array_equal(a.tokens, b.tokens)
    assert len({len(s.doc(i).tokens) for i in range(20)}) > 3  # varied


@pytest.mark.parametrize("dist", ["uniform", "poisson", "zipf"])
def test_docstream_distributions(dist):
    kw = dict(vocab_size=50, dist=dist, mean_len=128, max_len=512, seed=5)
    s, js = DocStream(**kw), jdata.DocStream(**kw)
    lens = [len(s.doc(i).tokens) for i in range(50)]
    assert all(16 <= n <= 512 for n in lens)
    for d, jd in zip(s.docs(10, 30), js.docs(10, 30)):
        assert d.doc_id == jd.doc_id
        assert d.tokens.dtype == jd.tokens.dtype == np.int32
        np.testing.assert_array_equal(d.tokens, jd.tokens)
    with pytest.raises(ValueError, match="unknown length dist"):
        DocStream(vocab_size=50, dist="gamma").doc(0)


def test_packing_no_leak_across_docs():
    s = DocStream(vocab_size=100, mean_len=40, max_len=100, seed=1)
    docs = s.docs(0, 8)
    pb = pack_documents(docs, rows=4, seq_len=128)
    assert pb.tokens.shape == (4, 128)
    for r in range(4):
        lab = pb.labels[r]
        valid = lab >= 0
        assert (lab[valid] == pb.tokens[r][1:][valid[:-1]]).all() if \
            valid[:-1].any() else True
    jdocs = jdata.DocStream(vocab_size=100, mean_len=40, max_len=100,
                            seed=1).docs(0, 8)
    want = jdata.pack_documents(jdocs, rows=4, seq_len=128)
    np.testing.assert_array_equal(pb.tokens, want.tokens)
    np.testing.assert_array_equal(pb.labels, want.labels)
    assert (pb.n_docs, pb.fill_ratio) == (want.n_docs, want.fill_ratio)


def test_packing_overflow_and_pad_as_reference():
    kw = dict(vocab_size=30, mean_len=200, max_len=600, seed=4)
    docs = DocStream(**kw).docs(0, 12)
    jdocs = jdata.DocStream(**kw).docs(0, 12)
    pb = pack_documents(docs, rows=2, seq_len=256, pad_id=7)
    want = jdata.pack_documents(jdocs, rows=2, seq_len=256, pad_id=7)
    assert pb.n_docs < len(docs)     # some documents do not fit
    np.testing.assert_array_equal(pb.tokens, want.tokens)
    np.testing.assert_array_equal(pb.labels, want.labels)
    assert (pb.n_docs, pb.fill_ratio) == (want.n_docs, want.fill_ratio)


def test_global_batch_shapes_and_balance():
    s = DocStream(vocab_size=100, mean_len=100, max_len=400, seed=2)
    docs = s.docs(0, 200)
    toks, labs, stats = make_global_batch(docs, (2, 4), rows_per_shard=4,
                                          seq_len=512)
    assert toks.shape == (2 * 4 * 4, 512)
    assert labs.shape == toks.shape
    works = np.array([st["work"] for st in stats])
    assert works.max() / max(works.mean(), 1e-9) < 1.5
    jdocs = jdata.DocStream(vocab_size=100, mean_len=100, max_len=400,
                            seed=2).docs(0, 200)
    powers = np.array([1.0, 0.5, 2.0, 1.0, 1.0, 0.0, 1.5, 1.0])
    for p in (None, powers):
        got = make_global_batch(docs, (2, 4), 4, 512, powers=p)
        want = jdata.make_global_batch(jdocs, (2, 4), 4, 512, powers=p)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_pipeline_resumable():
    s = DocStream(vocab_size=100, seed=3)
    p = Pipeline(s, shard_dims=(4,), rows_per_shard=2, seq_len=256)
    b1, _ = p.batch(5)
    b2, _ = p.batch(5)
    assert np.array_equal(b1["tokens"], b2["tokens"])


def test_pipeline_equals_reference_with_straggler_powers():
    kw = dict(shard_dims=(2, 2), rows_per_shard=2, seq_len=128)
    mon, jmon = _monitors(n_hosts=4)
    p = Pipeline(DocStream(vocab_size=64, mean_len=60, seed=9),
                 monitor=mon, **kw)
    jp = jdata.Pipeline(jdata.DocStream(vocab_size=64, mean_len=60, seed=9),
                        monitor=jmon, **kw)
    assert p.docs_per_step == jp.docs_per_step
    for step in range(4):
        got, stats = p.batch(step)
        want, jstats = jp.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
        assert stats == jstats
        times = np.array([1.0, 1.0 + step, 1.0, 0.5])
        mon.update(times)
        jmon.update(times)
