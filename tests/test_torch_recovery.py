"""The port's crash drill (``fl4health_tpu_torch/resilience/recovery.py``),
JAX's ``tests/resilience/test_recovery.py`` against the port: a real
subprocess ``fit`` SIGKILLed at a seeded point, resumed from the retention
ring by another, and its final params' bytes and loss history held equal to
an uninterrupted child's. Marked as JAX marks them: the post-save drill on
both sync routes and the ``KillPoint`` checks are ``crash``; the mid-write,
corrupt-generation, async and registry-scatter drills also ``slow``."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import os
import signal

import pytest

from fl4health_tpu_torch.resilience.recovery import (KillPoint, corrupt_newest_generation,
                                                     install_scatter_kill_hook, run_child)

FACTORY_FILE = os.path.join(os.path.dirname(__file__), "torch_recovery_factories.py")


def _run(tmp_path, tag, factory, n_rounds, ckpt_dir, kill=None):
    spec = {"factory_file": FACTORY_FILE, "factory_name": factory, "n_rounds": n_rounds,
            "ckpt_dir": str(ckpt_dir) if ckpt_dir is not None else None,
            "out_dir": str(tmp_path / f"{tag}_out"), "kill": kill, "device": "cpu"}
    return run_child(spec, str(tmp_path / f"{tag}_spec.json"))


def _drill(tmp_path, factory, n_rounds=4, kill=None, damage_newest=None):
    """Straight arm, killed arm, resumed arm; returns (straight, resumed,
    the damaged path or None)."""
    straight = _run(tmp_path, "straight", factory, n_rounds, tmp_path / "straight_ckpt")
    assert straight.returncode == 0, straight.stderr[-2000:]
    ckpt_dir = tmp_path / "drill_ckpt"
    killed = _run(tmp_path, "killed", factory, n_rounds, ckpt_dir, kill=kill)
    assert killed.returncode == -signal.SIGKILL, (
        f"expected SIGKILL exit, got {killed.returncode}: {killed.stderr[-2000:]}")
    assert killed.params_bytes is None
    damaged = None
    if damage_newest is not None:
        damaged = corrupt_newest_generation(str(ckpt_dir), mode=damage_newest)
    resumed = _run(tmp_path, "resumed", factory, n_rounds, ckpt_dir)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    return straight, resumed, damaged


def _assert_bit_identical(straight, resumed, n_rounds):
    assert resumed.params_bytes == straight.params_bytes, (
        "resumed final params differ from the uninterrupted run")
    assert resumed.history == straight.history
    assert [row["round"] for row in resumed.history] == list(range(1, n_rounds + 1))


@pytest.mark.crash
@pytest.mark.parametrize("factory", ["sync_chunked", "sync_pipelined"])
def test_sigkill_after_round2_resumes_bit_identical(tmp_path, factory):
    straight, resumed, _ = _drill(tmp_path, factory, kill={"round": 2, "phase": "post_save"})
    _assert_bit_identical(straight, resumed, 4)
    assert resumed.done["resume"]["next_round"] == 3


@pytest.mark.crash
@pytest.mark.slow
def test_sigkill_mid_checkpoint_write_leaves_previous_generation(tmp_path):
    straight, resumed, _ = _drill(
        tmp_path, "sync_chunked_every1",
        kill={"round": 2, "phase": "mid_write", "byte_offset": 200})
    _assert_bit_identical(straight, resumed, 4)
    assert resumed.done["resume"]["next_round"] == 2


@pytest.mark.crash
@pytest.mark.slow
@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_corrupt_newest_generation_falls_back_and_still_matches(tmp_path, damage):
    straight, resumed, damaged = _drill(
        tmp_path, "sync_chunked_every1", n_rounds=3, kill={"round": 2, "phase": "post_save"},
        damage_newest=damage)
    _assert_bit_identical(straight, resumed, 3)
    assert resumed.done["resume"]["fallback_skipped"] == [damaged]
    assert resumed.done["resume"]["next_round"] == 2


@pytest.mark.crash
@pytest.mark.slow
@pytest.mark.parametrize("factory", ["async_chunked", "async_pipelined"])
def test_async_sigkill_resumes_mid_plan_bit_identical(tmp_path, factory):
    straight, resumed, _ = _drill(tmp_path, factory, kill={"round": 2, "phase": "post_save"})
    _assert_bit_identical(straight, resumed, 4)


@pytest.mark.crash
@pytest.mark.bigcohort
@pytest.mark.slow
def test_sigkill_mid_registry_scatter_resumes_bit_identical(tmp_path):
    straight, resumed, _ = _drill(tmp_path, "cohort_sampled",
                                  kill={"round": 2, "phase": "registry_scatter"})
    _assert_bit_identical(straight, resumed, 4)


@pytest.mark.crash
def test_killpoint_validation():
    KillPoint(round=2, phase="registry_scatter")
    for bad, match in ((dict(round=2, phase="registry_scatter", signal_name="SIGTERM"),
                        "SIGKILL-only"),
                       (dict(round=2, phase="mid_write", signal_name="SIGTERM"),
                        "SIGKILL-only"),
                       (dict(round=2, phase="later"), "phase must be"),
                       (dict(round=0), "round must be"),
                       (dict(round=1, byte_offset=0), "byte_offset"),
                       (dict(round=1, signal_name="SIGINT"), "signal_name")):
        with pytest.raises(ValueError, match=match):
            KillPoint(**bad)
    assert KillPoint(round=1, signal_name="SIGTERM").signum == signal.SIGTERM

    class _NoRegistry:
        registry = None

    with pytest.raises(RuntimeError, match="cohort-slot"):
        install_scatter_kill_hook(_NoRegistry(), KillPoint(round=2, phase="registry_scatter"))
    with pytest.raises(ValueError, match="registry_scatter"):
        install_scatter_kill_hook(_NoRegistry(), KillPoint(round=2))
