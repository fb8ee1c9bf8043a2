"""The sweep's completion ledger in the port against JAX's: the grid
fingerprint is JAX's, a ledger either package's runner wrote restores every
cell in the other with nothing run, and JAX's resume tests
(``tests/sweep/test_resume.py``) hold on the port: full and partial
reruns, a torn tail, a foreign grid and header-less rows."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json

import pytest

from fl4health_tpu.sweep import run_sweep as jrun
from fl4health_tpu.sweep.runner import _spec_fingerprint as jfingerprint
from fl4health_tpu_torch.sweep import SweepLedger, SweepRunner
from fl4health_tpu_torch.sweep import run_sweep as trun_device
from fl4health_tpu_torch.sweep.runner import _spec_fingerprint as tfingerprint
from torch_sweep_sims import spec_pair


def trun(spec, **kw):
    return trun_device(spec, device="cpu", **kw)


def _specs(**overrides) -> tuple:
    kw = dict(strategies=("fedavg",), clients=("sgd",), seeds=(5, 7, 9, 11), max_pack=2)
    kw.update(overrides)
    return spec_pair(**kw)


def _rows(res) -> dict:
    return {r.cell.index: (r.fit_losses, r.eval_losses, r.cell.label()) for r in res.cells}


def _no_runs(monkeypatch):
    """Make any cell the runner would run fail the test."""
    def refuse(self, *a, **k):
        raise AssertionError("a restored grid ran a group")
    monkeypatch.setattr(SweepRunner, "_run_group", refuse)


@pytest.mark.parametrize("overrides", [{}, dict(rounds=3), dict(seeds=(1, 2)),
                                       dict(cohort_buckets=(4,)),
                                       dict(scalars={"server_lr": (0.1,)},
                                            strategies=("fedavg", "fedadam"))],
                         ids=["base", "rounds", "seeds", "bucket", "scalars"])
def test_the_fingerprint_is_jax(overrides):
    jspec, tspec = _specs(**overrides)
    assert (tfingerprint(tspec, tspec.expand_cells())
            == jfingerprint(jspec, jspec.expand_cells()))


def test_the_fingerprint_binds_the_grid_shape():
    _, a = _specs()
    _, b = _specs(rounds=3)
    assert tfingerprint(a, a.expand_cells()) != tfingerprint(b, b.expand_cells())


@pytest.fixture(scope="module")
def jax_ledger(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "ledger.jsonl")
    return path, jrun(_specs()[0], ledger_path=path)


def test_a_jax_ledger_restores_every_cell_in_the_port(jax_ledger, monkeypatch):
    path, jres = jax_ledger
    _no_runs(monkeypatch)
    tres = trun(_specs()[1], ledger_path=path)
    assert tres.resumed_cells == len(jres.cells) == 4
    assert tres.programs_compiled == 0
    assert _rows(tres) == _rows(jres)
    assert [r.row() for r in tres.cells] == [r.row() for r in jres.cells]
    assert tres.bench_block()["resumed_cells"] == 4


def test_a_port_ledger_restores_every_cell_in_jax(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    tres = trun(_specs()[1], ledger_path=path)
    jres = jrun(_specs()[0], ledger_path=path)
    assert jres.resumed_cells == len(tres.cells) == 4
    assert jres.programs_compiled == 0
    assert _rows(jres) == _rows(tres)


def test_a_full_rerun_restores_everything_and_runs_nothing(tmp_path, monkeypatch):
    ledger = str(tmp_path / "ledger.jsonl")
    first = trun(_specs()[1], ledger_path=ledger)
    assert first.resumed_cells == 0
    _no_runs(monkeypatch)
    again = trun(_specs()[1], ledger_path=ledger)
    assert again.resumed_cells == len(first.cells)
    assert again.programs_compiled == 0
    assert _rows(again) == _rows(first)
    assert "resumed_cells" in again.bench_block()
    assert "resumed_cells" not in first.bench_block()


def test_a_partial_ledger_reruns_only_the_missing_cells(tmp_path):
    ledger = str(tmp_path / "ledger.jsonl")
    full = trun(_specs()[1], ledger_path=ledger)
    # the header and the first pack (2 cells of 4)
    lines = open(ledger).read().splitlines()
    cell_lines = [ln for ln in lines if json.loads(ln).get("kind") == "cell"]
    open(ledger, "w").write("\n".join([lines[0]] + cell_lines[:2]) + "\n")
    ran = []
    run_group = SweepRunner._run_group

    def counting(self, group, *a, **k):
        ran.extend(c.index for c in group.cells)
        return run_group(self, group, *a, **k)

    SweepRunner._run_group = counting
    try:
        resumed = trun(_specs()[1], ledger_path=ledger)
    finally:
        SweepRunner._run_group = run_group
    assert resumed.resumed_cells == 2 and sorted(ran) == [2, 3]
    assert _rows(resumed) == _rows(full)
    final = trun(_specs()[1], ledger_path=ledger)
    assert final.resumed_cells == 4 and final.programs_compiled == 0


def test_a_torn_tail_line_is_skipped(tmp_path):
    ledger = str(tmp_path / "ledger.jsonl")
    trun(_specs()[1], ledger_path=ledger)
    with open(ledger, "a") as f:
        f.write('{"kind": "cell", "cell": 99, "label": "torn')  # no newline
    assert trun(_specs()[1], ledger_path=ledger).resumed_cells == 4


def test_a_foreign_grid_ledger_is_refused_as_jax(tmp_path):
    ledger = str(tmp_path / "ledger.jsonl")
    trun(_specs()[1], ledger_path=ledger)
    jother, tother = _specs(seeds=(1, 2))
    with pytest.raises(ValueError, match="different grid") as te:
        trun(tother, ledger_path=ledger)
    with pytest.raises(ValueError, match="different grid") as je:
        jrun(jother, ledger_path=ledger)
    assert str(te.value) == str(je.value)


def test_headerless_cell_rows_are_refused_as_jax(tmp_path):
    ledger = tmp_path / "ledger.jsonl"
    ledger.write_text('{"kind": "cell", "cell": 0, "label": "x"}\n')
    with pytest.raises(ValueError, match="no header") as te:
        trun(_specs()[1], ledger_path=str(ledger))
    with pytest.raises(ValueError, match="no header") as je:
        jrun(_specs()[0], ledger_path=str(ledger))
    assert str(te.value) == str(je.value)


def test_every_pack_is_on_disk_with_its_trajectories(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    spec = _specs()[1]
    res = trun(spec, ledger_path=path)
    recs = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert recs[0] == {"kind": "header", "spec_hash": tfingerprint(spec, spec.expand_cells()),
                       "version": 1}
    assert set(SweepLedger(path, recs[0]["spec_hash"]).load_completed()) == {0, 1, 2, 3}
    cell_recs = [r for r in recs if r["kind"] == "cell"]
    assert len(cell_recs) == len(res.cells)
    for r, cell in zip(cell_recs, res.cells):
        assert r["fit_losses"] == cell.fit_losses and r["eval_losses"] == cell.eval_losses


def test_no_ledger_keeps_a_fresh_run():
    res = trun(_specs(seeds=(5,))[1])
    assert res.resumed_cells == 0 and "resumed_cells" not in res.bench_block()
