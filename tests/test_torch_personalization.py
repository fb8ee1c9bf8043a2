"""The split-model personalised-FL family in the port (``clients/apfl.py``,
``fenda.py``, ``fedrep.py``, ``gpfl.py``, ``ensemble.py``,
``fedsimclr.py``) against the JAX package on the CPU, on JAX's fixture
(``tests/torch_pfl_sims.py``: 3 clients, 8 features, batch 8, SGD 0.05,
seed 3, 3 rounds), the port from JAX's converted init:

- APFL, FENDA, Constrained FENDA, PerFCL, FENDA+Ditto, FedRep, FedPer,
  GPFL, ensemble and FedSimCLR on the dense pipelined route: every
  round's fit and eval losses (each key) and eval metrics, the clients'
  params after eval, the global params and APFL's alphas within 5e-4, and
  each of JAX's end-to-end assertions on the port's run;
- APFL's alpha step by step through the engine's train step (a padding
  step among them), and APFL's evaluation reading the client's learned
  alpha from ``extra``, as JAX's does (the engine's eval once passed no
  ``extra``, so the port evaluated at ``alpha0``);
- each logic's chunked route equal to its pipelined route bit for bit;
- APFL's and PerFCL's ``extra`` carried through a checkpoint resume, bit
  for bit the straight run, and through a buffered-async run within 5e-4
  of JAX's;
- a cohort run of PerFCL, whose ``extra`` holds a model copy a registry
  row, within 5e-4 of JAX's.

Tolerance: 5e-4 (f32, the reference's)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fl4health_tpu.clients import engine as jengine
from fl4health_tpu.metrics.base import MetricManager as JMetricManager
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu_torch import optim
from fl4health_tpu_torch.checkpointing import SimulationStateCheckpointer
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.metrics.base import MetricManager as TMetricManager
from fl4health_tpu_torch.server import async_schedule as tas
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from torch_pfl_sims import (KINDS, TOL, batch_stack, client_spread, close_history,
                            close_params, flat, pair, recipe, step_states, tsim)


def _jax_checks(kind, thist, ts):
    """JAX's own end-to-end assertions (tests/clients/test_personalization.py
    and test_fedpm_simclr.py), on the port's run."""
    fit = [r.fit_losses for r in thist]
    ev = [r.eval_losses["checkpoint"] for r in thist]
    params = ts.client_states.params
    if kind == "apfl":
        alphas = ts.client_states.extra.alpha.numpy()
        assert np.all((alphas >= 0.0) & (alphas <= 1.0))
        assert np.max(np.abs(alphas - 0.5)) > 1e-5
        assert ev[-1] < ev[0]
    elif kind in ("fenda", "constrained_fenda", "perfcl"):
        assert client_spread(params, "second_feature_extractor/") == 0.0
        assert client_spread(params, "first_feature_extractor/") > 1e-6
        if kind == "fenda":
            assert ev[-1] < ev[0]
        if kind == "constrained_fenda":
            assert np.isfinite(fit[-1]["cos_sim"]) and fit[0]["contrastive"] == 0.0
            assert fit[1]["contrastive"] != 0.0
        if kind == "perfcl":
            assert fit[0]["global_contrastive"] == 0.0 and fit[1]["global_contrastive"] != 0.0
            assert np.isfinite(ev[-1])
    elif kind == "fenda_ditto":
        assert all(np.isfinite(f["penalty"]) for f in fit)
        assert client_spread(params, "global_model/") == 0.0
        assert client_spread(params, "personal_model/") > 1e-6
    elif kind in ("fedrep", "fedper"):
        assert client_spread(params, "features_module/") == 0.0
        assert client_spread(params, "head_module/") > 1e-7
    elif kind == "gpfl":
        for key in ("prediction_ce", "gce_softmax", "magnitude"):
            assert np.isfinite(fit[-1][key])
        assert client_spread(params, "head/") > 1e-7 and client_spread(params, "gce/") == 0.0
    elif kind == "ensemble":
        assert {"member_0", "member_1"} <= set(fit[-1]) and ev[-1] < ev[0]
    elif kind == "fedsimclr":
        assert np.isfinite(ev[-1]) and ev[-1] <= ev[0] + 0.5


@pytest.mark.parametrize("kind", KINDS)
def test_logic_matches_jax(kind):
    js, jhist, ts = pair(kind)
    thist = ts.fit(3)
    close_history(jhist, thist)
    close_params(flat(js.client_states.params), ts.client_states.params)
    close_params(flat(js.global_params), ts.global_params)
    if kind == "apfl":
        np.testing.assert_allclose(ts.client_states.extra.alpha.numpy(),
                                   np.asarray(js.client_states.extra.alpha), rtol=0, atol=TOL)
    _jax_checks(kind, thist, ts)


def _apfl():
    jlogic, _, tlogic, _, _ = recipe("apfl")
    return (jlogic, tlogic, *step_states(jlogic, tlogic))


def test_apfl_alpha_trajectory_matches_jax_step_by_step():
    jlogic, tlogic, jstate, tstate = _apfl()
    jstep = jax.jit(jengine.make_train_step(jlogic, optax.sgd(0.05)))
    tstep = tengine.make_train_step(tlogic, optim.sgd(0.05))
    masks = [1.0, 1.0, 0.0, 1.0, 1.0, 1.0]
    jbatches, tbatches = batch_stack("jax", masks), batch_stack("port", masks)
    jtraj, ttraj = [], []
    for s in range(len(masks)):
        jstate, _ = jstep(jstate, None, jax.tree_util.tree_map(lambda a: a[s], jbatches))
        tstate, _ = tstep(tstate, None, ptu.tree_map(lambda a: a[s], tbatches))
        jtraj.append(float(jstate.extra.alpha))
        ttraj.append(float(tstate.extra.alpha))
    np.testing.assert_allclose(ttraj, jtraj, rtol=0, atol=1e-6)
    assert ttraj[2] == ttraj[1]  # the padding step
    assert abs(ttraj[-1] - 0.5) > 1e-4


def test_apfl_evaluates_with_the_learned_alpha_as_jax():
    jlogic, tlogic, jstate, tstate = _apfl()
    jbatches, tbatches = batch_stack("jax", [1.0, 1.0]), batch_stack("port", [1.0, 1.0])
    jeval = jengine.make_local_eval(jlogic, JMetricManager(()))
    teval = tengine.make_local_eval(tlogic, TMetricManager(()))
    losses = {}
    for alpha in (0.5, 0.9):
        js = jstate.replace(extra=jstate.extra.replace(alpha=jnp.float32(alpha)))
        ts = dataclasses.replace(tstate, extra=dataclasses.replace(
            tstate.extra, alpha=torch.tensor(alpha)))
        want = float(jeval(js, None, jbatches)[0]["checkpoint"])
        got = float(teval(ts, None, tbatches)[0]["checkpoint"])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        losses[alpha] = got
    assert abs(losses[0.9] - losses[0.5]) > 1e-3


def _same_history(a, b):
    assert [r.round for r in a.history] == [r.round for r in b.history]
    for ra, rb in zip(a.history, b.history):
        for f in ("fit_losses", "fit_metrics", "eval_losses", "eval_metrics"):
            assert getattr(ra, f) == getattr(rb, f), (ra.round, f)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_route_is_the_pipelined_route_bit_for_bit(kind):
    runs = {}
    for mode in ("pipelined", "chunked"):
        *_, tlogic, texch, ssl = recipe(kind)
        runs[mode] = tsim(tlogic, texch, ssl, mode=mode)
        runs[mode].fit(3)
    piped, chunked = runs["pipelined"], runs["chunked"]
    _same_history(piped, chunked)
    for a, b in zip(ptu.tree_leaves(piped.client_states), ptu.tree_leaves(chunked.client_states),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["apfl", "perfcl"])
def test_a_resume_carries_extra_as_the_straight_run(tmp_path, kind):
    """The logic's ``extra`` (APFL's alphas, PerFCL's model copy) rides the
    checkpoint frame: ``fit(2)`` saving every round, then a fresh
    simulation on the same ring ``fit(4)``, is the straight ``fit(4)`` bit
    for bit."""
    def sim(directory):
        *_, tlogic, texch, ssl = recipe(kind)
        return tsim(tlogic, texch, ssl, mode="chunked",
                    state_checkpointer=SimulationStateCheckpointer(str(directory), keep=4))

    sim(tmp_path / "run").fit(2)
    resumed = sim(tmp_path / "run")
    resumed.fit(4)
    straight = sim(tmp_path / "straight")
    straight.fit(4)
    assert resumed._resume_info["next_round"] == 3
    _same_history(straight, resumed)
    for a, b in zip(ptu.tree_leaves(straight.client_states),
                    ptu.tree_leaves(resumed.client_states), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["apfl", "perfcl"])
def test_a_buffered_async_run_matches_jax(kind):
    """The logics on the buffered-async route (buffer 2 of 3, seed 13, 4
    events): each event's losses and the clients' params against JAX's."""
    js, jhist, ts = pair(kind, rounds=4,
                         jax_kw=dict(async_config=jas.AsyncConfig(buffer_size=2, seed=13)),
                         port_kw=dict(async_config=tas.AsyncConfig(buffer_size=2, seed=13)))
    thist = ts.fit(4)
    close_history(jhist, thist)
    close_params(flat(js.global_params), ts.global_params)
    close_params(flat(js.client_states.params), ts.client_states.params)


def test_perfcl_cohort_run_matches_jax():
    """6 clients in a registry, 3 slots, half sampled a round: the PerFCL
    ``extra`` (last round's model and its flag) rides each client's
    registry row between the rounds it is sampled in."""
    manager = lambda m: m.FixedFractionManager(6, 0.5)  # noqa: E731
    js, jhist, ts = pair("perfcl", rounds=4,
                         jax_kw=dict(n_clients=6, cohort=jreg.CohortConfig(slots=3),
                                     client_manager=manager(jcm)),
                         port_kw=dict(n_clients=6, cohort=treg.CohortConfig(slots=3),
                                      client_manager=manager(tcm)))
    thist = ts.fit(4)
    close_history(jhist, thist)
    close_params(flat(js.global_params), ts.global_params)
    assert ts.registry.dirty_rows == js.registry.dirty_rows
    ids = np.asarray(sorted(js.registry._client_store._rows))
    jrows, trows = (sim.registry.gather_client_states(ids) for sim in (js, ts))
    close_params(flat(jrows.params), trows.params)
    close_params(flat(jrows.extra.old_params), trows.extra.old_params)
    np.testing.assert_array_equal(np.asarray(trows.extra.have_old),
                                  np.asarray(jrows.extra.have_old))
    assert any(r.fit_losses["global_contrastive"] != 0.0 for r in thist)
