"""The fleet ledger (``observability/fleet.py``) against the JAX package:

- a run's ledger equals JAX's on the tiny DP recipe, dense and over a
  cohort (records keyed by REGISTRY ids, ``registry_size`` from the
  cohort): ids, counts and rounds exact, losses and norms at 5e-4;
- with observability on, a port frame carrying the ledger under
  ``"fleet"`` is byte-equal to JAX's at one clock, and each package's
  ledger restores the other's document;
- a killed-and-resumed run adopts the frame's ledger and absorbs each round
  exactly once, equal to a straight run's."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import numpy as np
import pytest

from fl4health_tpu.checkpointing import state as jstate
from fl4health_tpu.observability import fleet as jfleet
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu_torch.checkpointing import state as tstate
from fl4health_tpu_torch.observability import fleet as tfleet
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from torch_obs_sims import TOL, data_of, jax_init, obs_of, sim_of


def assert_docs_close(got, want, path="doc"):
    """Two JSON documents: the same structure, ints and strings exact,
    floats within TOL relative."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_docs_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_docs_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6, err_msg=path)
    else:
        assert got == want, path


COHORT = lambda pkg: dict(  # noqa: E731
    cohort=(jreg if pkg == "jax" else treg).CohortConfig(slots=3),
    client_manager=(jcm if pkg == "jax" else tcm).FixedFractionManager(6, 0.5))


@pytest.mark.parametrize("kind", ["dense", "cohort"])
def test_ledger_equals_jax(kind):
    docs = {}
    for pkg in ("jax", "torch"):
        obs = obs_of(pkg)
        kw = COHORT(pkg) if kind == "cohort" else {}
        sim = sim_of(pkg, data_of(6 if kind == "cohort" else 4), obs=obs, **kw)
        if pkg == "jax":
            init = jax_init(sim)
        else:
            sim.set_global_params(init)
        sim.fit(3)
        docs[pkg] = obs.fleet_ledger.snapshot()
        if kind == "cohort":
            # keyed by registry id: more clients seen than the 3 slots
            assert len(obs.fleet_ledger) > 3
    assert_docs_close(docs["torch"], docs["jax"])


def _ledger(module):
    led = module.FleetLedger()
    r = np.random.default_rng(4)
    for rnd in range(1, 4):
        ids = np.asarray(sorted(r.choice(10, 4, replace=False)), np.int64)
        led.absorb_round(rnd, ids, losses=r.random(4).astype(np.float32),
                         update_norms=r.random(4).astype(np.float32),
                         staleness_pool=[0.0, 1.0], failed_ids=[int(ids[0])],
                         fault_ids=[int(ids[1])] if rnd == 2 else [],
                         bytes_down_per_client=1234, bytes_up_per_client=1234,
                         registry_size=10)
    return led


def test_frames_with_the_ledger_are_byte_equal_and_read_both_ways(tmp_path, monkeypatch):
    tdoc, jdoc = _ledger(tfleet).snapshot(), _ledger(jfleet).snapshot()
    assert tdoc == jdoc
    monkeypatch.setattr(jstate.time, "time", lambda: 1.5e9)
    monkeypatch.setattr(tstate.time, "time", lambda: 1.5e9)
    trees = {"server_state": {"w": np.arange(6, dtype=np.float32)},
             "client_states": {"rng": np.array([[0, 7], [0, 9]], np.uint32)}}
    paths = {}
    for name, mod, doc in (("jax", jstate, jdoc), ("torch", tstate, tdoc)):
        ck = mod.SimulationStateCheckpointer(str(tmp_path / name), keep=2,
                                             config_hash="0123456789abcdef")
        ck.save_simulation_snapshot(trees, 3, 2, [], fleet=doc)
        (paths[name],) = [p for _, p in ck.generations()]
    assert open(paths["jax"], "rb").read() == open(paths["torch"], "rb").read()
    for reader, ledger_mod, path in ((tstate, tfleet, paths["jax"]),
                                     (jstate, jfleet, paths["torch"])):
        host, _meta, _blob = reader.read_frame(path)
        led = ledger_mod.FleetLedger()
        led.restore(host["fleet"])
        assert led.snapshot() == jdoc


@pytest.mark.parametrize("mode", ["chunked", "pipelined"])
def test_resume_absorbs_each_round_once(tmp_path, mode):
    straight_obs = obs_of("torch")
    sim_of("torch", data_of(4), dp=False, mode=mode, obs=straight_obs).fit(4)
    d = str(tmp_path / "ckpt")
    first = sim_of("torch", data_of(4), dp=False, mode=mode, obs=obs_of("torch"),
                   state_checkpointer=tstate.SimulationStateCheckpointer(d, keep=2))
    first.fit(2)
    newest = tstate.StateCheckpointer(d).candidate_paths()[0][1]
    assert tstate.read_frame(newest)[0]["fleet"] == first.observability.fleet_ledger.snapshot()
    resumed_obs = obs_of("torch")
    resumed = sim_of("torch", data_of(4), dp=False, mode=mode, obs=resumed_obs,
                     state_checkpointer=tstate.SimulationStateCheckpointer(d, keep=2))
    resumed.fit(4)
    assert resumed._resume_info["next_round"] == 3
    ledger = resumed_obs.fleet_ledger
    assert [ledger.get(c)["rounds_participated"] for c in range(4)] == [4] * 4
    assert_docs_close(ledger.snapshot(), straight_obs.fleet_ledger.snapshot())
    # a frame without a ledger clears it
    resumed.adopt_fleet_snapshot(None)
    assert len(ledger) == 0
