"""The port's sweep runner (``sweep/spec.py``, ``bucketing.py``,
``runner.py``) against the JAX package's, on JAX's sweep fixtures
(``tests/sweep/test_sweep.py``: an ``Mlp(12)`` on 6 features, 3 clients, 2
rounds, batch 8, 2 local steps), the same numpy data and flax init in both:

- the spec's validation, with JAX's messages; ``expand_cells``' cells,
  order and labels; ``plan_groups``' groups, buckets and row budgets; both
  padding guards;
- the 8-cell grid (2 strategies x ``sgd``/``mrmtl`` x 2 seeds): every cell
  equals the port's standalone chunked ``fit`` bit for bit, and JAX's cell
  at 5e-4; so do a padded-bucket cell (3 -> 4), a fault-plan cell and a
  manager cell;
- a padded cell is its standalone run bit for bit up to 32 clients; from
  20 clients JAX's is not, and from 33 neither package's (R11, ROADMAP.md
  C);
- packed equals sequential bit for bit, with a remainder pack;
- the events and the ``fl_sweep_*`` metrics carry JAX's names and help."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import numpy as np
import pytest

from fl4health_tpu.resilience.faults import ClientFault as JFault
from fl4health_tpu.resilience.faults import FaultPlan as JPlan
from fl4health_tpu.server.client_manager import FixedFractionManager as JFixed
from fl4health_tpu.server.client_manager import PoissonSamplingManager as JPoisson
from fl4health_tpu.sweep import run_sweep as jrun
from fl4health_tpu.sweep import bucketing as jbucketing
from fl4health_tpu_torch.resilience.faults import ClientFault as TFault
from fl4health_tpu_torch.resilience.faults import FaultPlan as TPlan
from fl4health_tpu_torch.server.client_manager import FixedFractionManager as TFixed
from fl4health_tpu_torch.server.client_manager import PoissonSamplingManager as TPoisson
from fl4health_tpu_torch.sweep import bucketing as tbucketing
from fl4health_tpu_torch.sweep import run_sweep as trun_device
from torch_sweep_sims import TOL, partitioner, spec_pair, standalone


def trun(spec, **kw):
    return trun_device(spec, device="cpu", **kw)


def _plans(kind: str, probability: float = 1.0) -> tuple:
    """A fault plan of client 1 scaled by -2 from round 2, in each package."""
    def build(plan, fault):
        return plan(seed=3, client_faults=(fault(clients=(1,), kind=kind, scale=-2.0,
                                                 probability=probability, start_round=2),))
    return build(JPlan, JFault), build(TPlan, TFault)


def _managers(cls_pair) -> tuple:
    jcls, tcls = cls_pair
    return ({"full": lambda c: None, "half": lambda c: jcls(c, 0.5)},
            {"full": lambda c: None, "half": lambda c: tcls(c, 0.5)})


def _raises_alike(jax_call, port_call):
    with pytest.raises(Exception) as je:
        jax_call()
    with pytest.raises(Exception) as te:
        port_call()
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("bad", [
    dict(strategies=()), dict(clients=()), dict(salts=()), dict(rounds=0),
    dict(local_steps=0), dict(batch_size=0), dict(seeds=()), dict(cohort_sizes=()),
    dict(max_pack=0), dict(cohort_sizes=(3, 9), cohort_buckets=(4,)),
    dict(cohort_buckets=()), dict(scalars={"not_a_knob": (1.0,)}),
    dict(pairs={"client_managers": ({}, {})}),
    dict(pairs={"client_managers": ({"full": lambda c: JFixed(c, 0.5)},
                                    {"full": lambda c: TFixed(c, 0.5)})}),
], ids=["strategies", "clients", "partitioners", "rounds", "local_steps", "batch_size",
        "seeds", "cohort_sizes", "max_pack", "too_big_for_bucket", "empty_buckets",
        "unknown_scalar", "no_managers", "full_reserved"])
def test_spec_validation_raises_as_jax(bad):
    _raises_alike(lambda: spec_pair(**bad)[0], lambda: spec_pair(**bad)[1])


def _grid_axes() -> dict:
    jplan, tplan = _plans("scale")
    jm, tm = _managers((JFixed, TFixed))
    return dict(salts=(0, 1), cohort_sizes=(3, 4), scalars={"server_lr": (0.1, 0.3)},
                pairs={"fault_plans": ({"none": None, "scale2": jplan},
                                       {"none": None, "scale2": tplan}),
                       "client_managers": (jm, tm)})


def _cell_tuple(c) -> tuple:
    return (c.index, c.label(), c.strategy, c.client, c.partitioner, c.cohort, c.fault,
            c.seed, c.scalars, c.manager)


def test_expand_cells_equal_jax_with_collapsed_scalars_and_the_manager_axis():
    jspec, tspec = spec_pair(**_grid_axes())
    jcells, tcells = jspec.expand_cells(), tspec.expand_cells()
    assert [_cell_tuple(c) for c in tcells] == [_cell_tuple(c) for c in jcells]
    assert tspec.applicable_scalar_axes() == jspec.applicable_scalar_axes()
    # server_lr binds fed_adam only: fedavg cells collapse to no scalars
    assert all(c.scalars == () for c in tcells if c.strategy == "fedavg")
    assert {c.scalar_dict["server_lr"] for c in tcells if c.strategy == "fedadam"} == {0.1, 0.3}
    assert not any("m:" in c.label() for c in tcells if c.manager == "full")
    assert len(tcells) == 2 * 2 * 2 * 2 * 2 * 2 * 2 + 2 * 2 * 2 * 2 * 2 * 2  # 96


@pytest.mark.parametrize("buckets", [None, (4,), (3, 8)])
def test_plan_groups_equal_jax(buckets):
    jspec, tspec = spec_pair(salts=(0, 1), cohort_sizes=(3, 4), cohort_buckets=buckets)
    jcache, tcache = {}, {}

    def data_for(spec, cache):
        def get(part, cohort):
            return cache.setdefault((part, cohort), spec.partitioners[part](cohort))
        return get

    jplan = jbucketing.plan_groups(jspec, jspec.expand_cells(), data_for(jspec, jcache))
    tplan = tbucketing.plan_groups(tspec, tspec.expand_cells(), data_for(tspec, tcache))
    assert tplan.describe() == jplan.describe()
    assert tplan.buckets == jplan.buckets
    assert [(g.key.label(), g.train_row_budget, g.val_row_budget, [c.index for c in g.cells])
            for g in tplan.groups] == [
        (g.key.label(), g.train_row_budget, g.val_row_budget, [c.index for c in g.cells])
        for g in jplan.groups]


@pytest.mark.parametrize("guard", ["fault", "manager"])
def test_padding_guards_refuse_as_jax(guard):
    kw = dict(strategies=("fedavg",), clients=("sgd",), seeds=(5,), cohort_buckets=(4,))
    if guard == "fault":
        jplan, tplan = _plans("dropout", probability=0.5)
        kw["pairs"] = {"fault_plans": ({"flaky": jplan}, {"flaky": tplan})}
    else:
        kw["pairs"] = {"client_managers": ({"poisson": lambda c: JPoisson(c, 0.5)},
                                           {"poisson": lambda c: TPoisson(c, 0.5)})}
    jspec, tspec = spec_pair(**kw)
    _raises_alike(lambda: jrun(jspec), lambda: trun(tspec))


def test_a_wrong_sized_manager_is_refused_as_jax():
    jspec, tspec = spec_pair(("fedavg",), ("sgd",), seeds=(5,), pairs={
        "client_managers": ({"bad": lambda c: JFixed(c + 1, 0.5)},
                            {"bad": lambda c: TFixed(c + 1, 0.5)})})
    _raises_alike(lambda: jrun(jspec), lambda: trun(tspec))


@pytest.fixture(scope="module")
def grid():
    jspec, tspec = spec_pair()
    return tspec, trun(tspec), jrun(jspec)


def test_the_grid_has_jax_groups_and_no_run_time_compile(grid):
    _, tres, jres = grid
    assert len(tres.cells) == 8 and len(tres.plan.groups) == 4
    assert tres.plan.describe() == jres.plan.describe()
    assert [r.group for r in tres.cells] == [r.group for r in jres.cells]
    assert tres.programs_compiled == 0 and tres.cells_per_compile is None
    assert set(tres.bench_block()) == set(jres.bench_block())


@pytest.mark.parametrize("i", range(8))
def test_each_grid_cell_is_its_standalone_chunked_fit_and_jax_cell(grid, i):
    tspec, tres, jres = grid
    r, j = tres.cells[i], jres.cells[i]
    assert r.cell.label() == j.cell.label()
    fit_ref, eval_ref = standalone(r.cell, tspec, partitioner(0, False)(3), False)
    assert r.fit_losses == fit_ref and r.eval_losses == eval_ref, r.cell.label()
    np.testing.assert_allclose(r.fit_losses, j.fit_losses, rtol=0, atol=TOL)
    np.testing.assert_allclose(r.eval_losses, j.eval_losses, rtol=0, atol=TOL)
    assert r.row().keys() == j.row().keys()


def _one_cell_case(kind: str):
    """(JAX spec, port spec, standalone kwargs of each package) of one
    fedavg/sgd cell: a padded bucket, a fault plan or a manager."""
    kw = dict(seeds=(5,))
    jsim_kw, tsim_kw = {}, {}
    if kind == "padded":
        kw["cohort_buckets"] = (4,)
    elif kind == "fault":
        jplan, tplan = _plans("scale")
        kw["pairs"] = {"fault_plans": ({"scale2": jplan}, {"scale2": tplan})}
        jsim_kw, tsim_kw = dict(fault_plan=jplan), dict(fault_plan=tplan)
    else:
        jm, tm = _managers((JFixed, TFixed))
        kw["pairs"] = {"client_managers": ({"half": jm["half"]}, {"half": tm["half"]})}
        jsim_kw, tsim_kw = dict(client_manager=JFixed(3, 0.5)), dict(
            client_manager=TFixed(3, 0.5))
    jspec, tspec = spec_pair(("fedadam",), ("sgd",), **kw)
    return jspec, tspec, jsim_kw, tsim_kw


@pytest.mark.parametrize("kind", ["padded", "fault", "manager"])
def test_a_padded_a_fault_and_a_manager_cell_match_both_references(kind):
    jspec, tspec, jsim_kw, tsim_kw = _one_cell_case(kind)
    (r,), (j,) = trun(tspec).cells, jrun(jspec).cells
    if kind == "padded":
        assert (r.bucket, r.cell.cohort) == (4, 3) == (j.bucket, j.cell.cohort)
    fit_ref, eval_ref = standalone(r.cell, tspec, partitioner(0, False)(3), False, **tsim_kw)
    assert r.fit_losses == fit_ref and r.eval_losses == eval_ref
    np.testing.assert_allclose(r.fit_losses, j.fit_losses, rtol=0, atol=TOL)
    np.testing.assert_allclose(r.eval_losses, j.eval_losses, rtol=0, atol=TOL)
    # JAX's own cell against JAX's standalone run, as JAX's tests hold it
    jfit, jeval = standalone(j.cell, jspec, partitioner(0, True)(3), True, **jsim_kw)
    np.testing.assert_array_equal(j.eval_losses, jeval)


@pytest.mark.parametrize("cohort,bucket", [(6, 8), (12, 16), (20, 32)])
def test_a_padded_cell_up_to_32_clients_is_its_standalone_run(cohort, bucket):
    """The phantom rows are zeros at the end of every client-axis sum:
    ``client_sum``'s order and the aggregate's chain of fused multiply-adds
    (up to 32 clients) do not change for them."""
    _, tspec = spec_pair(("fedadam",), ("sgd",), seeds=(5,), cohort_sizes=(cohort,),
                         cohort_buckets=(bucket,))
    (r,) = trun(tspec).cells
    assert (r.bucket, r.cell.cohort) == (bucket, cohort)
    assert (r.fit_losses, r.eval_losses) == standalone(
        r.cell, tspec, partitioner(0, False)(cohort), False)


@pytest.mark.parametrize("cohort,bucket", [(20, 32), (33, 40)])
def test_r11_a_padded_cell_is_not_its_standalone_run_in_jax_from_20_clients(cohort, bucket):
    """R11: JAX's padded cell parts from its standalone run by an ulp at 20
    clients in 32 (its loss reductions regroup) and at 33 in 40; the port's
    at 33 in 40, where its aggregate mirrors XLA's windows of 32 rows
    (padded half before), which group 33 rows and 40 rows differently."""
    jspec, tspec = spec_pair(("fedadam",), ("sgd",), seeds=(5,), cohort_sizes=(cohort,),
                             cohort_buckets=(bucket,))
    (r,), (j,) = trun(tspec).cells, jrun(jspec).cells
    tfit, teval = standalone(r.cell, tspec, partitioner(0, False)(cohort), False)
    jfit, jeval = standalone(j.cell, jspec, partitioner(0, True)(cohort), True)
    assert (j.fit_losses, j.eval_losses) != (jfit, jeval)
    assert ((r.fit_losses, r.eval_losses) == (tfit, teval)) == (cohort <= 32)
    for got, want in ((r.eval_losses, teval), (j.eval_losses, jeval),
                      (r.fit_losses, tfit), (j.fit_losses, jfit)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_packed_and_sequential_agree_bit_for_bit_with_a_remainder_pack():
    kw = dict(strategies=("fedavg",), clients=("sgd",), seeds=(5, 7, 11), rounds=1,
              local_steps=1)
    packed = trun(spec_pair(max_pack=2, **kw)[1])
    sequential = trun(spec_pair(pack=False, **kw)[1])
    whole = trun(spec_pair(max_pack=4, **kw)[1])
    assert packed.pack and not sequential.pack
    for a, b, c in zip(packed.cells, sequential.cells, whole.cells):
        assert a.cell == b.cell == c.cell
        assert a.fit_losses == b.fit_losses == c.fit_losses
        assert a.eval_losses == b.eval_losses == c.eval_losses


def test_events_and_metrics_carry_jax_names(tmp_path):
    from fl4health_tpu.observability import Observability as JObs
    from fl4health_tpu_torch.observability import MetricsRegistry, Observability, Tracer

    jobs = JObs(enabled=True, output_dir=str(tmp_path))
    jobs.start()
    tobs = Observability(enabled=True, registry=MetricsRegistry(), tracer=Tracer(),
                         introspection=False)
    kw = dict(strategies=("fedavg",), clients=("sgd",), seeds=(5, 7), rounds=1,
              local_steps=1)
    jspec, tspec = spec_pair(**kw)
    jres, tres = jrun(jspec, observability=jobs), trun(tspec, observability=tobs)
    jevents, tevents = list(jobs.registry.events), list(tobs.registry.events)
    kinds = lambda evs: [e["event"] for e in evs if e["event"].startswith("sweep")]  # noqa: E731
    assert kinds(tevents) == kinds(jevents) == ["sweep_plan", "sweep", "sweep", "sweep_summary"]
    for name in ("sweep_plan", "sweep", "sweep_summary"):
        t = next(e for e in tevents if e["event"] == name)
        j = next(e for e in jevents if e["event"] == name)
        assert set(t) == set(j), name
    for metric in ("fl_sweep_cells_total", "fl_sweep_programs_compiled",
                   "fl_sweep_compile_seconds_total", "fl_sweep_wall_seconds"):
        kind = "counter" if metric.endswith("_total") else "gauge"
        tm = getattr(tobs.registry, kind)(metric)
        jm = getattr(jobs.registry, kind)(metric)
        assert tm.help == jm.help, metric
    assert tobs.registry.gauge("fl_sweep_programs_compiled").value == float(
        tres.programs_compiled) == 0.0
    assert tobs.registry.counter("fl_sweep_cells_total").value == len(tres.cells) == len(
        jres.cells)
    # no compile, no cells-per-compile gauge (JAX sets it only when it exists)
    assert "fl_sweep_cells_per_compile" not in tobs.registry.to_prometheus()
    jobs.shutdown()


def test_the_package_exports_jax_all():
    import fl4health_tpu.sweep as jsweep
    import fl4health_tpu_torch.sweep as tsweep

    assert tsweep.__all__ == jsweep.__all__
    assert all(hasattr(tsweep, name) for name in tsweep.__all__)
