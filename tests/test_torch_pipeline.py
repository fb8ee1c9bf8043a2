"""The port's round pipeline (``fl4health_tpu_torch/server/pipeline.py`` and
the pipelined ``fit``) on the CPU: the ``SingleWorkerQueue``/
``RoundConsumer`` contracts of ``tests/server/test_pipeline.py``, the
prefetcher's staleness rule and miss, a consumer failure ending ``fit``,
``fit(0)``, the one-transfer pull, the pipelined history against the inline
path (bit for bit: the consumer computes nothing on the device), and a
3-round FedAvg MLP run against the JAX simulation's pipelined path, from the
converted flax init and the same data, within 5e-4 (the f32 CPU tolerance of
tests/conftest.py)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics import efficient as jefficient
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.models.cnn import Mlp as JMlp
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core.workqueue import SingleWorkerQueue
from fl4health_tpu_torch.metrics import efficient as tefficient
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.models.cnn import Mlp as TMlp
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.server.pipeline import HostPull, RoundConsumer, RoundPrefetcher
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg

N_CLASSES, DIM = 3, 6
TOL = 5e-4


def _arrays(n_clients=3, seed=0, n=56):
    """Per-client (x, y) numpy arrays: 32 train, 16 val, 8 test rows."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_clients):
        x = r.standard_normal((n, DIM)).astype(np.float32)
        y = r.integers(0, N_CLASSES, n).astype(np.int32)
        out.append((x, y))
    return out


def _datasets(module, n_clients=3, seed=0, with_test=False):
    out = []
    for x, y in _arrays(n_clients, seed):
        kw = dict(x_test=x[48:], y_test=y[48:]) if with_test else {}
        out.append(module.ClientDataset(x[:32], y[:32], x[32:48], y[32:48], **kw))
    return out


def _sim(**kwargs):
    defaults = dict(
        logic=tengine.ClientLogic(tengine.from_module(TMlp(DIM, (12,), N_CLASSES)),
                                  tengine.masked_cross_entropy),
        tx=optim.sgd(0.05), strategy=TFedAvg(), datasets=_datasets(tsim), batch_size=8,
        metrics=TMetricManager((tefficient.accuracy(),)), local_epochs=1, seed=5,
        execution_mode="pipelined", device="cpu")
    defaults.update(kwargs)
    return tsim.FederatedSimulation(**defaults)


def _consumer_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("fl-round-consumer", "fl-round-prefetch"))]


# ---------------------------------------------------------------------------
# SingleWorkerQueue / RoundConsumer
# ---------------------------------------------------------------------------

def test_jobs_run_in_submission_order():
    c = RoundConsumer(maxsize=2)
    seen = []
    for i in range(8):
        # stagger job durations so out-of-order execution would show
        c.submit(lambda i=i: (time.sleep(0.002 * (8 - i)), seen.append(i)))
    c.flush()
    c.close()
    assert seen == list(range(8))


def test_flush_is_a_barrier():
    c = RoundConsumer()
    done = threading.Event()
    c.submit(lambda: (time.sleep(0.05), done.set()))
    c.flush()
    assert done.is_set()
    c.close()


def test_exception_propagates_to_submit_and_flush_once():
    c = RoundConsumer(maxsize=4)
    ran_after_failure = []

    def boom():
        raise ValueError("round 2 epilogue failed")

    c.submit(boom)
    c._queue.join()  # let the worker consume it
    with pytest.raises(ValueError, match="round 2"):
        c.submit(lambda: ran_after_failure.append(1))
    c.flush()  # raised exactly once; clean afterwards
    c.close()
    assert ran_after_failure == []


def test_jobs_after_failure_are_skipped():
    c = SingleWorkerQueue(maxsize=4)
    ran = []

    def boom():
        raise RuntimeError("x")

    c.submit(boom)
    c._queue.join()
    c._queue.put(lambda: ran.append(1))  # submit would raise: enqueue directly
    c._queue.join()
    assert ran == []
    with pytest.raises(RuntimeError):
        c.raise_pending()
    c.close()


def test_queue_is_bounded_and_blocks_the_producer():
    c = RoundConsumer(maxsize=3)
    assert c.maxsize == 3
    unbounded = RoundConsumer(maxsize=0)
    assert unbounded.maxsize == 1  # clamped: never unbounded
    unbounded.close()
    gate = threading.Event()
    c.submit(gate.wait)  # the worker holds this one
    for _ in range(3):
        c.submit(lambda: None)  # fills the queue
    blocked = threading.Thread(target=c.submit, args=(lambda: None,))
    blocked.start()
    blocked.join(timeout=0.2)
    assert blocked.is_alive()  # a fourth pending job waits for room
    gate.set()
    blocked.join(timeout=10)
    assert not blocked.is_alive()
    c.flush()
    c.close()
    c.close()  # idempotent


def test_closed_consumer_rejects_submissions():
    c = RoundConsumer()
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c.submit(lambda: None)


def test_submit_round_tracks_the_last_completed_round():
    c = RoundConsumer()
    for r in (1, 2, 3):
        c.submit_round(r, lambda: None)
    c.flush()
    c.close()
    assert c.last_completed_round == 3


# ---------------------------------------------------------------------------
# HostPull
# ---------------------------------------------------------------------------

def test_host_pull_is_one_buffer_with_the_trees_values():
    tree = {"mask": torch.tensor([1.0, 0.0, 1.0]),
            "fit": {"backward": torch.tensor(0.25), "acc": torch.tensor(float("nan"))},
            "rows": {"backward": torch.tensor([1.5, -2.0, float("inf")])}}
    pull = HostPull(tree)
    assert pull.nbytes == 8 * 4  # 8 f32 values in one buffer
    host = pull.result()
    assert isinstance(host["mask"], np.ndarray) and host["mask"].dtype == np.float32
    np.testing.assert_array_equal(host["rows"]["backward"], [1.5, -2.0, np.inf])
    assert float(host["fit"]["backward"]) == 0.25
    assert np.isnan(host["fit"]["acc"])
    # a leaf of another dtype gets a buffer of its own; every value stays exact
    mixed = HostPull({"n": torch.tensor([2**24 + 1], dtype=torch.int64),
                      "x": torch.tensor(0.1)})
    got = mixed.result()
    assert int(got["n"][0]) == 2**24 + 1
    assert np.float32(got["x"]) == np.float32(0.1) and got["x"].dtype == np.float32


# ---------------------------------------------------------------------------
# RoundPrefetcher
# ---------------------------------------------------------------------------

def _batches_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "y", "example_mask", "step_mask"))


def test_prefetcher_miss_builds_on_the_callers_thread():
    sim = _sim()
    pf = RoundPrefetcher(sim)
    try:
        pf.schedule(1)
        assert _batches_equal(pf.take(2), sim._round_batches(2))  # staged 1, asked 2
        assert _batches_equal(pf.take(1), sim._round_batches(1))  # nothing staged
        pf.schedule(3)
        assert _batches_equal(pf.take(3), sim._round_batches(3))  # a hit
    finally:
        pf.close()


def _fresh_data(seed):
    xs, ys = [], []
    for x, y in _arrays(3, seed, n=32):
        xs.append(x)
        ys.append(y)
    return xs, ys


def _provider(rnd):
    # fresh train arrays from round 2 on: round 2's batches were already
    # staged against the original stacks while round 1 ran
    return _fresh_data(100 * rnd) if rnd >= 2 else None


def test_prefetch_stays_correct_when_provider_swaps_data():
    rounds = 3
    a = _sim(train_data_provider=_provider)
    staged_stacks = []
    real_schedule = RoundPrefetcher.schedule

    def schedule(self, round_idx):
        staged_stacks.append((round_idx, self._sim._x_train_stack))
        real_schedule(self, round_idx)

    RoundPrefetcher.schedule = schedule
    try:
        hist = a.fit(rounds)
    finally:
        RoundPrefetcher.schedule = real_schedule
    # round 2 was staged before the provider's swap: the staleness rule had
    # to gather it again
    assert [r for r, _ in staged_stacks] == [1, 2, 3]
    assert staged_stacks[1][1] is not a._x_train_stack

    # the same rounds driven by hand, without a prefetcher or consumer
    b = _sim(train_data_provider=_provider)
    val_batches, val_counts = b._val_batches()
    ref = []
    for r in range(1, rounds + 1):
        fresh = _provider(r)
        if fresh is not None:
            b.set_train_data(*fresh)
        mask = b.client_manager.sample(tsim.rng.fold_in(b.rng, 2000 + r), r)
        (b.server_state, b.client_states, losses, _m, _p) = b._fit_round(
            b.server_state, b.client_states, b._round_batches(r), mask, r, val_batches)
        b.client_states = b._eval_round(b.server_state, b.client_states, val_batches,
                                        val_counts)[0]
        ref.append(float(losses["backward"]))
    assert [h.fit_losses["backward"] for h in hist] == ref
    # and the swap did change the run
    plain = _sim().fit(rounds)
    assert [h.fit_losses["backward"] for h in plain][1:] != ref[1:]


def test_set_train_data_refuses_another_layout():
    sim = _sim()
    xs, ys = _fresh_data(1)
    with pytest.raises(ValueError, match="x_train stack"):
        sim.set_train_data([x[:, :4] for x in xs], ys)
    with pytest.raises(ValueError, match="y_train stack"):
        sim.set_train_data(xs, [y.astype(np.int64) for y in ys])


# ---------------------------------------------------------------------------
# The pipelined fit
# ---------------------------------------------------------------------------

def test_pipelined_history_equals_the_inline_path_bit_for_bit():
    rounds = 3
    piped = _sim(datasets=_datasets(tsim, with_test=True))
    hist = piped.fit(rounds)

    inline = _sim(datasets=_datasets(tsim, with_test=True))
    val_batches, val_counts = inline._val_batches()
    for r in range(1, rounds + 1):
        inline._run_round(r, val_batches, val_counts)  # no consumer: inline epilogue
    assert [h.round for h in hist] == [h.round for h in inline.history] == [1, 2, 3]
    for a, b in zip(hist, inline.history):
        for field in ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics"):
            assert getattr(a, field) == getattr(b, field), field
    for k, v in inline.global_params.items():
        assert torch.equal(piped.global_params[k], v), k
    assert torch.equal(piped.client_states.rng, inline.client_states.rng)


def test_the_producer_never_synchronizes(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    hist = _sim().fit(2)
    assert len(hist) == 2 and calls == []


def test_one_pull_a_round(monkeypatch):
    pulls = []
    real = HostPull.result

    def result(self):
        pulls.append(threading.current_thread().name)
        return real(self)

    monkeypatch.setattr(HostPull, "result", result)
    _sim(datasets=_datasets(tsim, with_test=True)).fit(3)
    # one transfer a round, taken on the consumer's thread
    assert len(pulls) == 3 and all(n.startswith("fl-round-consumer") for n in pulls)


def test_a_consumer_failure_aborts_fit_and_tears_the_pipeline_down():
    class Failing:
        def report(self, data, round=None, epoch=None, step=None):
            if round == 2:
                raise OSError("disk full at round 2")

        def shutdown(self):
            raise AssertionError("an aborted fit does not shut reporters down")

    sim = _sim(reporters=[Failing()])
    with pytest.raises(OSError, match="round 2"):
        sim.fit(6)
    # round 2's epilogue raised in its report, after its record landed; the
    # epilogues of the rounds the producer had dispatched meanwhile (at most
    # the pipeline's depth) were skipped
    assert [h.round for h in sim.history] == [1, 2]
    assert sim._consumer is None and sim._prefetcher is None
    assert _consumer_threads() == []
    sim.reporters = []
    assert [h.round for h in sim.fit(1)][-1] >= 2  # the sim stays usable


def test_fit_zero_runs_nothing():
    sim = _sim()
    before = {k: v.clone() for k, v in sim.global_params.items()}
    keys = sim.client_states.rng.clone()
    assert sim.fit(0) == []
    assert all(torch.equal(sim.global_params[k], v) for k, v in before.items())
    assert torch.equal(sim.client_states.rng, keys)
    assert _consumer_threads() == []
    assert [h.round for h in sim.fit(1)] == [1]


# ---------------------------------------------------------------------------
# Against the JAX simulation
# ---------------------------------------------------------------------------

def test_fedavg_mlp_pipelined_run_matches_jax():
    rounds = 3
    js = jsim.FederatedSimulation(
        logic=jengine.ClientLogic(jengine.from_flax(JMlp(features=(12,), n_outputs=N_CLASSES)),
                                  jengine.masked_cross_entropy),
        tx=optax.sgd(0.05), strategy=JFedAvg(), datasets=_datasets(jsim), batch_size=8,
        metrics=JMetricManager((jefficient.accuracy(),)), local_epochs=1, seed=5,
        execution_mode="pipelined")
    ts = _sim()
    ts.set_global_params(convert.flax_to_torch(
        jax.tree_util.tree_map(np.asarray, js.global_params)))
    jhist, thist = js.fit(rounds), ts.fit(rounds)
    assert [r.round for r in thist] == [r.round for r in jhist] == [1, 2, 3]
    for jr, tr in zip(jhist, thist):
        for field in ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics"):
            got, want = getattr(tr, field), getattr(jr, field)
            assert set(got) == set(want), field
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0,
                                           err_msg=f"{field}[{k}] round {jr.round}")
    want = convert.flax_to_torch(jax.tree_util.tree_map(np.asarray, js.global_params))
    for k, v in want.items():
        np.testing.assert_allclose(ts.global_params[k].numpy(), v.numpy(), atol=TOL,
                                   rtol=0, err_msg=k)
