"""The port's checkpoint and resume (``fl4health_tpu_torch/checkpointing``,
wired into ``server/simulation.py``) on the CPU, against itself and JAX:

- the resume matrix: a run saved after round 2 of 4 and resumed by a fresh
  simulation on the same directory equals the port's straight run bit for
  bit (history, server and client states), and JAX's resumed run within
  5e-4, on both sync routes and across them, on the cohort routes with the
  compressed exchange's error-feedback rows (every dirty registry row
  bit-equal) and on both dense async routes mid-plan (the frame's
  ``pending`` bit-equal to the straight run's at the same event);
- ``fit(2); fit(4)`` on one simulation, which restores its own frame as JAX
  does;
- ``_resume_config_hash`` equal to JAX's for the dense, cohort, async,
  compressed and bf16 recipes, and a changed config refused;
- JAX's composition errors and route reasons, word for word;
- the model checkpointers firing in ``fit``, their files against JAX's;
- the async writer's ordering and error contracts (JAX's
  ``tests/checkpointing/test_async_writer.py``)."""

import numpy as np
import pytest
import torch

from fl4health_tpu.checkpointing import checkpointer as jckpt
from fl4health_tpu.checkpointing import state as jstate
from fl4health_tpu.compression.config import CompressionConfig as JCompression
from fl4health_tpu.precision.policy import PrecisionConfig as JPrecision
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch.checkpointing import checkpointer as tckpt
from fl4health_tpu_torch.checkpointing import serialization
from fl4health_tpu_torch.checkpointing import state as tstate
from fl4health_tpu_torch.checkpointing.async_writer import AsyncCheckpointWriter
from fl4health_tpu_torch.compression.config import CompressionConfig as TCompression
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.precision.policy import PrecisionConfig as TPrecision
from fl4health_tpu_torch.server import async_schedule as tas
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from tests.torch_async_sims import (assert_matches_jax, flat, jax_init, jsim_of, rows,
                                    same_history, tsim_of)

DATA = rows(4)
COHORT_DATA = rows(6)


def _recipe(name, pkg):
    """Constructor kwargs of a recipe in package ``pkg`` ("jax"/"torch")."""
    j = pkg == "jax"
    if name == "dense":
        return {}
    if name == "cohort":
        return dict(cohort=(jreg if j else treg).CohortConfig(slots=3),
                    client_manager=(jcm if j else tcm).FixedFractionManager(6, 0.5),
                    compression=(JCompression if j else TCompression)(
                        topk_fraction=0.5, error_feedback=True))
    if name == "async":
        return dict(async_config=(jas if j else tas).AsyncConfig(buffer_size=2, seed=13))
    if name == "compressed":
        return dict(compression=(JCompression if j else TCompression)(
            topk_fraction=0.5, error_feedback=True, quant_bits=8, seed=3))
    if name == "bf16":
        return dict(precision=(JPrecision if j else TPrecision)("bf16"))
    raise KeyError(name)


def _sims(recipe, mode, ckpt_dir=None, **kw):
    data = COHORT_DATA if recipe == "cohort" else DATA
    out = {}
    for pkg, make, sc, strat in (("jax", jsim_of, jstate, JFedAvg),
                                 ("torch", tsim_of, tstate, TFedAvg)):
        args = dict(_recipe(recipe, pkg), **kw)
        if ckpt_dir is not None:
            args["state_checkpointer"] = sc.SimulationStateCheckpointer(
                str(ckpt_dir / pkg), keep=4)
        out[pkg] = make(data, strat(), mode=mode, **args)
    return out["jax"], out["torch"]


def _states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        ptu.tree_leaves((a.server_state, a.client_states)),
        ptu.tree_leaves((b.server_state, b.client_states))))


def _rows_equal(a, b) -> bool:
    ea, eb = a.registry.export_rows(), b.registry.export_rows()
    la, lb = ptu.tree_leaves(ea), ptu.tree_leaves(eb)
    return len(la) == len(lb) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                      for x, y in zip(la, lb))


def _frame_blob(ckpt_dir, round_idx):
    for _gen, path in tstate.StateCheckpointer(str(ckpt_dir)).candidate_paths():
        _h, meta, blob = tstate.read_frame(path)
        if meta["round"] == round_idx:
            return blob
    raise AssertionError(f"no frame of round {round_idx} in {ckpt_dir}")


MATRIX = [("dense", "chunked", "chunked"), ("dense", "pipelined", "pipelined"),
          ("dense", "pipelined", "chunked"), ("cohort", "chunked", "chunked"),
          ("cohort", "pipelined", "pipelined"), ("cohort", "pipelined", "chunked"),
          ("async", "chunked", "chunked"),
          ("async", "pipelined", "pipelined")]


@pytest.mark.parametrize("recipe,save_mode,resume_mode", MATRIX,
                         ids=["-".join(c) for c in MATRIX])
def test_resume_is_the_straight_run_and_jax_resume(tmp_path, recipe, save_mode, resume_mode):
    js, ts = _sims(recipe, save_mode, tmp_path / "run")
    init = jax_init(js)
    js.fit(2)
    ts.set_global_params(init)
    ts.fit(2)
    js2, ts2 = _sims(recipe, resume_mode, tmp_path / "run")
    js2.fit(4)
    ts2.fit(4)
    assert ts2._resume_info["next_round"] == 3 and ts2._resume_info["kind"] == (
        {"dense": "sync"}.get(recipe, recipe))
    _, straight = _sims(recipe, resume_mode, tmp_path / "straight")
    straight.set_global_params(init)
    straight.fit(4)
    assert [r.round for r in ts2.history] == [1, 2, 3, 4]
    assert same_history(straight, ts2)
    assert _states_equal(straight, ts2)
    if recipe == "cohort":
        assert ts2.registry.dirty_rows > 0 and _rows_equal(straight, ts2)
    if recipe == "async":
        # the frame the resume read (event 2: server, clients, pending)
        # is the straight run's at event 2, bit for bit
        assert (_frame_blob(tmp_path / "run" / "torch", 2)
                == _frame_blob(tmp_path / "straight" / "torch", 2))
    assert_matches_jax(ts2, js2.history, js2)
    stats = [m["checkpoint"] for m in ts2.round_metrics if "checkpoint" in m]
    assert [s["round"] for s in stats] == [3, 4]
    assert all(s["bytes"] > 0 and s["write_s"] >= 0 and s["generation"] >= 3 for s in stats)


def test_fit_twice_on_one_sim_resumes_its_own_frame_as_jax(tmp_path):
    js, ts = _sims("dense", "chunked", tmp_path)
    ts.set_global_params(jax_init(js))
    js.fit(2)
    js.fit(4)
    ts.fit(2)
    ts.fit(4)
    assert [r.round for r in js.history] == [r.round for r in ts.history] == [1, 2, 3, 4]
    assert_matches_jax(ts, js.history, js)
    # without a checkpointer the port's own numbering: fit(n) runs n more
    plain = tsim_of(DATA, TFedAvg(), mode="chunked")
    plain.fit(2)
    plain.fit(4)
    assert [r.round for r in plain.history] == [1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("recipe", ["dense", "cohort", "async", "compressed", "bf16"])
def test_resume_config_hash_equals_jax(recipe):
    js, ts = _sims(recipe, "auto")
    assert ts._resume_config_hash() == js._resume_config_hash()
    assert ts._manifest_config(3) == js._manifest_config(3)


def test_changed_config_and_client_count_are_refused(tmp_path):
    ts = tsim_of(DATA, TFedAvg(), state_checkpointer=tstate.SimulationStateCheckpointer(
        str(tmp_path)))
    ts.fit(1)
    other = tsim_of(DATA, TFedAvg(), local_epochs=2,
                    state_checkpointer=tstate.SimulationStateCheckpointer(str(tmp_path)))
    with pytest.raises(tstate.CheckpointConfigMismatchError, match="config_hash"):
        other.fit(2)
    fewer = tsim_of(DATA[:3], TFedAvg(),
                    state_checkpointer=tstate.SimulationStateCheckpointer(str(tmp_path)))
    with pytest.raises(ValueError, match="checkpoint has 4 clients, run has 3"):
        fewer.fit(2)


def test_async_plan_seed_change_raises_jax_fingerprint_message(tmp_path):
    """A changed ``AsyncConfig`` seed changes the config hash too; bound to
    the frame's hash, the resume reaches the plan check and refuses with
    JAX's message."""
    msgs = []
    for pkg, make, sc, strat, mod in (("jax", jsim_of, jstate, JFedAvg, jas),
                                      ("torch", tsim_of, tstate, TFedAvg, tas)):
        d = str(tmp_path / pkg)
        cfg = lambda seed: mod.AsyncConfig(buffer_size=2, compute_jitter=0.3,  # noqa: E731
                                           seed=seed)
        first = make(DATA, strat(), async_config=cfg(13),
                     state_checkpointer=sc.SimulationStateCheckpointer(d))
        first.fit(2)
        other = make(DATA, strat(), async_config=cfg(14),
                     state_checkpointer=sc.SimulationStateCheckpointer(
                         d, config_hash=first.state_checkpointer.config_hash))
        with pytest.raises(ValueError, match="fingerprint mismatch") as ei:
            other.fit(4)
        msgs.append(str(ei.value).replace(d, "<dir>"))
    assert msgs[0] == msgs[1]


class _LegacyCheckpointer:
    """The legacy API: ``save_simulation`` only."""

    def __init__(self):
        self.saved = []

    def save_simulation(self, sim, rnd):
        self.saved.append(rnd)


def _error(make, strat, **kw):
    with pytest.raises(ValueError) as ei:
        make(COHORT_DATA if "cohort" in kw else DATA, strat(), **kw)
    return str(ei.value)


@pytest.mark.parametrize("case", ["async_model_ckpt", "async_cohort_state", "async_legacy",
                                  "cohort_legacy"])
def test_composition_errors_equal_jax(tmp_path, case):
    msgs = []
    for pkg, make, sc, ck, strat in (("jax", jsim_of, jstate, jckpt, JFedAvg),
                                     ("torch", tsim_of, tstate, tckpt, TFedAvg)):
        kw = {}
        if case.startswith("async"):
            kw["async_config"] = _recipe("async", pkg)["async_config"]
        if "cohort" in case:
            kw.update(cohort=_recipe("cohort", pkg)["cohort"],
                      client_manager=_recipe("cohort", pkg)["client_manager"])
        if case == "async_model_ckpt":
            kw["model_checkpointers"] = [(ck.CheckpointMode.POST_AGGREGATION,
                                          ck.LatestCheckpointer(str(tmp_path / "m")))]
        elif case == "async_cohort_state":
            kw["state_checkpointer"] = sc.SimulationStateCheckpointer(str(tmp_path))
        else:
            kw["state_checkpointer"] = _LegacyCheckpointer()
        msgs.append(_error(make, strat, **kw))
    assert msgs[0] == msgs[1]


def test_route_reasons_equal_jax(tmp_path):
    for kw_of in (
            lambda ck, sc: dict(model_checkpointers=[(ck.CheckpointMode.POST_AGGREGATION,
                                                      ck.LatestCheckpointer(str(tmp_path)))]),
            lambda ck, sc: dict(state_checkpointer=_LegacyCheckpointer()),
            lambda ck, sc: dict(state_checkpointer=sc.SimulationStateCheckpointer(
                str(tmp_path)))):
        js = jsim_of(DATA, JFedAvg(), **kw_of(jckpt, jstate))
        ts = tsim_of(DATA, TFedAvg(), **kw_of(tckpt, tstate))
        assert ts._select_execution_mode(2) == js._select_execution_mode(2)
    assert ts._select_execution_mode(2)[0] == tsim.EXEC_CHUNKED
    assert js._rounds_per_dispatch(5, 2) == ts._rounds_per_dispatch(5, 2) == 1


def test_legacy_checkpointer_saves_every_round():
    legacy = _LegacyCheckpointer()
    ts = tsim_of(DATA, TFedAvg(), state_checkpointer=legacy)
    assert ts._select_execution_mode(3)[0] == tsim.EXEC_PIPELINED
    ts.fit(3)
    assert legacy.saved == [1, 2, 3]


def test_model_checkpointers_fire_in_fit(tmp_path):
    files = {}
    for pkg, make, ck, strat in (("jax", jsim_of, jckpt, JFedAvg),
                                 ("torch", tsim_of, tckpt, TFedAvg)):
        post = ck.BestLossCheckpointer(str(tmp_path / f"{pkg}_post.msgpack"))
        pre = ck.LatestCheckpointer(str(tmp_path / f"{pkg}_pre.msgpack"))
        sim = make(DATA, strat(), model_checkpointers=[
            (ck.CheckpointMode.POST_AGGREGATION, post), (ck.CheckpointMode.PRE_AGGREGATION, pre)])
        if pkg == "jax":
            init = jax_init(sim)
        else:
            sim.set_global_params(init)
            assert sim._select_execution_mode(2) == (
                tsim.EXEC_PIPELINED, "per-round model checkpointing needs per-round host access")
        sim.fit(2)
        files[pkg] = (post.path, pre.path)
        if pkg == "torch":
            restored = post.load(sim.global_params)
            assert list(restored) == list(sim.global_params)
            stacked = tckpt.load_params(pre.path, sim.client_states.params)
            assert all(v.shape[0] == sim.n_clients for v in stacked.values())
            assert post.async_writer is None and pre.async_writer is None
    for j, t in zip(*files.values()):
        jt = serialization.msgpack_restore(open(j, "rb").read())
        tt = serialization.msgpack_restore(open(t, "rb").read())
        np.testing.assert_allclose(flat(convert._flatten(tt)), flat(convert._flatten(jt)),
                                   atol=5e-4, rtol=0)


# -- the async writer (JAX's tests/checkpointing/test_async_writer.py) -----------

def _params(v: float):
    return {"w": np.full((3,), v, np.float32)}


def test_writer_submit_save_is_durable_after_flush(tmp_path):
    w = AsyncCheckpointWriter()
    path = str(tmp_path / "p.msgpack")
    w.submit_save(path, _params(1.5))
    w.flush()
    np.testing.assert_allclose(tckpt.load_params(path, _params(0.0))["w"], 1.5)
    w.close()


def test_writer_keeps_writes_ordered(tmp_path):
    w = AsyncCheckpointWriter(maxsize=2)
    path = str(tmp_path / "latest.msgpack")
    for v in range(8):
        w.submit_save(path, _params(float(v)))
    w.flush()
    w.close()
    np.testing.assert_allclose(tckpt.load_params(path, _params(0.0))["w"], 7.0)


def test_writer_raises_once_and_skips_later_jobs():
    w = AsyncCheckpointWriter()
    ran = []

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    w._queue.join()
    with pytest.raises(OSError, match="disk full"):
        w.submit(lambda: ran.append(1))
    w.flush()
    assert ran == []
    w.close()


def test_writer_close_is_idempotent_and_refuses_after(tmp_path):
    w = AsyncCheckpointWriter()
    w.close()
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit_save(str(tmp_path / "x"), _params(0.0))


def test_checkpointer_persists_through_an_attached_writer(tmp_path):
    w = AsyncCheckpointWriter()
    ck = tckpt.BestLossCheckpointer(str(tmp_path / "best.msgpack"))
    ck.async_writer = w
    assert ck.maybe_checkpoint(_params(1.0), 1.0, {})
    assert not ck.maybe_checkpoint(_params(2.0), 2.0, {})
    assert ck.maybe_checkpoint(_params(3.0), 0.5, {})
    w.flush()
    np.testing.assert_allclose(tckpt.load_params(ck.path, _params(0.0))["w"], 3.0)
    ck.async_writer = None
    ck.maybe_checkpoint(_params(4.0), 0.4, {})
    np.testing.assert_allclose(tckpt.load_params(ck.path, _params(0.0))["w"], 4.0)
    w.close()


def test_a_failed_frame_write_surfaces_from_fit(tmp_path):
    sc = tstate.SimulationStateCheckpointer(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")

    sc.save = broken
    ts = tsim_of(DATA, TFedAvg(), mode="pipelined", state_checkpointer=sc)
    with pytest.raises(OSError, match="disk full"):
        ts.fit(2)
