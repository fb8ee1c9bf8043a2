"""Buffered async over the client registry (``async_config`` with
``cohort=CohortConfig(...)``, JAX's ``_fit_async_registry``) in the port on
the CPU, against itself and against the JAX package
(``tests/server/test_cohort_slots.py``'s ``TestAsyncOverRegistry``):

- ``K`` = N seats under full participation with no stragglers is the
  synchronous cohort run bit for bit (every swap an identity);
- ``K < N``: the seats swap occupants, and the run (history, global params,
  every client's registry row, the error-feedback rows of a compressed
  exchange, each event's facts) matches JAX's within 5e-4; it reruns bit
  for bit; every evicted occupant's stored row is its state when it left
  its seat;
- a failure is named by the pre-swap occupant's registry id, as in JAX;
- the chunked route is refused with JAX's reason."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import pytest

from fl4health_tpu.compression.config import CompressionConfig as JCompression
from fl4health_tpu.resilience import faults as jfaults
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu.server import registry as jreg
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch.compression.config import CompressionConfig as TCompression
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.resilience import faults as tfaults
from fl4health_tpu_torch.server import async_schedule as tas
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from tests.torch_async_sims import (TOL, assert_matches_jax, flat, jax_init, jsim_of, rows,
                                    same_history, tsim_of)


def _kw(pkg, n_slots, buffer, faults=True, **extra):
    jax_side = pkg == "jax"
    fm, am, rm = (jfaults, jas, jreg) if jax_side else (tfaults, tas, treg)
    plan = (fm.FaultPlan(client_faults=(fm.ClientFault(clients=(0,), kind="slow", scale=5.0),))
            if faults else None)
    return dict(strategy=JFedAvg() if jax_side else TFedAvg(),
                cohort=rm.CohortConfig(slots=n_slots), fault_plan=plan,
                async_config=am.AsyncConfig(buffer_size=buffer, compute_jitter=0.05
                                            if faults else 0.0), **extra)


def test_full_seating_is_the_sync_cohort_run_bit_for_bit():
    data = rows(4)
    sync = tsim_of(data, TFedAvg(), mode="pipelined", cohort=treg.CohortConfig(slots=4))
    dense = tsim_of(data, TFedAvg(), async_config=tas.AsyncConfig(buffer_size=4))
    asy = tsim_of(data, **_kw("torch", 4, 4, faults=False))
    for sim in (sync, dense, asy):
        sim.fit(3)
    assert same_history(sync, asy) and same_history(dense, asy)
    assert np.array_equal(flat(sync.global_params), flat(asy.global_params))
    # the seats' rows, stored at the end, are the dense async run's clients
    assert np.array_equal(flat(dense.client_states),
                          flat(asy.registry.gather_client_states(np.arange(4))))
    assert [m["swapped"] for m in asy.round_metrics] == [0, 0, 0]


CASES = {
    # name: (registry size, slots, buffer, events, extra kwargs (package -> dict))
    "fedavg": (6, 3, 2, 5, lambda p: {}),
    "compressed_error_feedback": (6, 3, 2, 4, lambda p: dict(compression=(
        JCompression if p == "jax" else TCompression)(topk_fraction=0.5, error_feedback=True,
                                                      quant_bits=8, seed=3))),
}


def _jrows(js, ids, strategy=False):
    reg = js.registry
    tree = reg.gather_strategy_rows(ids) if strategy else reg.gather_client_states(ids).params
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.mark.parametrize("case", list(CASES))
def test_swapping_seats_match_jax(case):
    n, slots, buffer, events, extra = CASES[case]
    data = rows(n)
    js = jsim_of(data, **_kw("jax", slots, buffer, **extra("jax")))
    init = jax_init(js)
    jhist = js.fit(events)
    runs = []
    for _ in range(2):
        ts = tsim_of(data, mode="auto", **_kw("torch", slots, buffer, **extra("torch")))
        assert ts._select_execution_mode(events) == js._select_execution_mode(events)
        ts.set_global_params(init)
        ts.fit(events)
        runs.append(ts)
    ts = runs[0]
    assert same_history(*runs)  # a rerun is the same run, bit for bit
    assert np.array_equal(ts._async_plan.slot_ids, js._async_plan.slot_ids)
    assert (ts._async_plan.slot_ids[0] != ts._async_plan.slot_ids[-1]).any()
    assert_matches_jax(ts, jhist, js)
    ids = np.arange(n)
    assert ts.registry.dirty_rows == js.registry.dirty_rows == n
    for k, v in convert.flax_to_torch(_jrows(js, ids)).items():
        np.testing.assert_allclose(ts.registry.gather_client_states(ids).params[k],
                                   v.numpy(), atol=TOL, rtol=0, err_msg=k)
    if ts.registry.has_strategy_rows:
        want = _jrows(js, ids, strategy=True)["residual"]
        got = ts.registry.gather_strategy_rows(ids)["residual"]
        for k, v in convert.flax_to_torch(want).items():
            np.testing.assert_allclose(got[k], v.numpy(), atol=TOL, rtol=0, err_msg=k)
    swaps = [int((a != b).sum()) for a, b in zip(js._async_plan.slot_ids[:-1],
                                                   js._async_plan.slot_ids[1:])]
    assert [m["swapped"] for m in ts.round_metrics] == swaps and sum(swaps) > 0
    assert all(m["cohort_draw"] == "event_plan" and m["cohort_slots"] == slots
               and m["registry_size"] == n for m in ts.round_metrics)
    assert [m["fault"] for m in ts.round_metrics] == [
        js._fault_plan.summarize_round(e, slots) for e in range(1, events + 1)]


def test_evicted_rows_are_the_clients_states_when_they_left():
    ts = tsim_of(rows(6), **_kw("torch", 3, 2))
    left, swap = [], ts._swap_seats

    def recording(changed, old_ids, new_ids):
        # the occupants' live rows just before the swap
        left.append((np.asarray(old_ids).copy(), flat(ts.client_states.params),
                     [flat({k: v[int(c)] for k, v in ts.client_states.params.items()})
                      for c in changed]))
        out = swap(changed, old_ids, new_ids)
        stored = ts.registry.gather_client_states(np.asarray(old_ids)).params
        for j, cid in enumerate(old_ids):
            assert np.array_equal(flat({k: v[j] for k, v in stored.items()}), left[-1][2][j])
        return out

    ts._swap_seats = recording
    ts.fit(5)
    assert len(left) >= 2


def test_a_failure_is_named_by_the_pre_swap_occupant():
    data = rows(6)
    x, y, xv, yv = data[4]
    data[4] = (np.full_like(x, np.nan), y, xv, yv)  # client 4 trains to a NaN loss
    errors = []
    for pkg, build in (("jax", jsim_of), ("torch", tsim_of)):
        fp = (jsim if pkg == "jax" else tsim).FailurePolicy(accept_failures=False)
        sim = build(data, **_kw(pkg, 3, 2, failure_policy=fp))
        with pytest.raises((jsim if pkg == "jax" else tsim).ClientFailuresError) as err:
            sim.fit(5)
        errors.append((err.value.round, err.value.clients, err.value.registry_clients))
    assert errors[0] == errors[1]
    assert errors[1][2] == [4]


def test_the_chunked_route_is_refused_with_jax_reason():
    data = rows(6)
    msgs = []
    for pkg, build in (("jax", jsim_of), ("torch", tsim_of)):
        sim = build(data, mode="chunked", **_kw(pkg, 3, 2))
        with pytest.raises(ValueError) as err:
            sim.fit(2)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == (
        "execution_mode='chunked' but buffered-async over the registry swaps slot "
        "occupants host-side per event (pipelined per-event path)")
    # slots < N under full participation is the normal async shape; a
    # buffer larger than the slots is refused, word for word
    for pkg, build in (("jax", jsim_of), ("torch", tsim_of)):
        with pytest.raises(ValueError) as err:
            build(data, **_kw(pkg, 3, 4))
        msgs.append(str(err.value))
    assert msgs[2] == msgs[3]
