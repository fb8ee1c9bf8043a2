"""The device probe (``utils/tpu_probe.py``), with no card: the sentinel
line parsed from the child, a crash reported as ``error: ...``, a hang as
``down``, the classification and the JSON-line helper equal to JAX's, and
one real child (torch, no JAX) naming this process's platform."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import pytest
import torch

from fl4health_tpu.utils import tpu_probe as jprobe
from fl4health_tpu_torch.utils import tpu_probe


def test_real_child_names_the_platform():
    assert tpu_probe.probe_platform(120) == ("gpu" if torch.cuda.is_available() else "cpu")
    assert "jax" not in tpu_probe._PROBE_SRC and tpu_probe._SENTINEL == jprobe._SENTINEL


@pytest.mark.parametrize("src,timeout,want", [
    (f"print('{tpu_probe._SENTINEL}gpu')", 60, "gpu"),
    (f"print('{tpu_probe._SENTINEL}cpu'); print('INFO: runtime idle')", 60, "cpu"),
    ("print('gpu')", 60, ""),
    ("import time; time.sleep(60)", 1, "down"),
])
def test_probe_parses_the_child(monkeypatch, src, timeout, want):
    monkeypatch.setattr(tpu_probe, "_PROBE_SRC", src)
    assert tpu_probe.probe_platform(timeout) == want


def test_crashing_child_reports_error_not_down(monkeypatch):
    monkeypatch.setattr(tpu_probe, "_PROBE_SRC", "import nonexistent_module_xyz_12345")
    out = tpu_probe.probe_platform(60)
    assert out.startswith("error") and "nonexistent_module_xyz_12345" in out


@pytest.mark.parametrize("platform", ["gpu", "tpu", "cpu", "down", "",
                                      "error: ModuleNotFoundError: no module named torch"])
def test_classification_equals_jax(platform):
    assert tpu_probe.is_accelerator(platform) is jprobe.is_accelerator(platform)


@pytest.mark.parametrize("text", ['{"a": 1}\nnoise\n{"b": 2}', '{"a": 1}\n{broken', "none"])
def test_last_json_line_equals_jax(text):
    assert tpu_probe.last_json_line(text) == jprobe.last_json_line(text)
