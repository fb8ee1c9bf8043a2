"""The port stands alone: no module of fl4health_tpu_torch, and none of
chip_smoke.py and the port's tools (tools/torch_port_*.py) imports JAX,
flax, optax, msgpack (the card's machine has none; the port writes flax's
msgpack bytes itself) or the JAX package, the package imports with them
made unimportable, and a crash-drill child (``python -m
fl4health_tpu_torch.resilience.recovery``) loads none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "fl4health_tpu")
SOURCES = sorted((ROOT / "fl4health_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("torch_port_*.py"))]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


def test_sources_were_found():
    names = {p.name for p in SOURCES}
    assert {"flash_attention.py", "simulation.py", "engine.py", "chip_smoke.py",
            "dp_clip.py", "dpsgd.py", "instance_level_dp.py", "torch_port_round_profile.py",
            "torch_port_kernel_resources.py", "rng.py", "client_manager.py",
            "clipping.py", "client_dp_fedavgm.py", "packer.py", "partitioners.py",
            "samplers.py", "vision.py", "accountants.py", "rdp.py", "servers.py",
            "workqueue.py", "io.py", "pipeline.py", "base.py", "scaffold.py", "fedprox.py",
            "moon.py", "drift.py", "contrastive.py", "bases.py", "optim.py", "fedopt.py",
            "exchanger.py", "peft.py", "policy.py", "convert.py", "unet.py", "plans.py",
            "data.py", "augment.py", "segmentation.py", "nnunet.py", "efficient.py",
            "aggregate.py", "registry.py", "registry_presets.py", "codecs.py",
            "config.py", "strategy.py", "async_schedule.py", "faults.py", "aggregators.py",
            "fedbuff.py", "serialization.py", "state.py", "checkpointer.py",
            "async_writer.py", "manifest.py", "recovery.py", "inference.py",
            "medical.py"} <= names


def test_package_imports_without_jax():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    modules = sorted(
        "fl4health_tpu_torch." + ".".join(p.relative_to(ROOT / "fl4health_tpu_torch")
                                          .with_suffix("").parts)
        for p in (ROOT / "fl4health_tpu_torch").rglob("*.py") if p.name != "__init__.py")
    code = (f"import sys; {blocked}; import importlib; "
            f"[importlib.import_module(m) for m in {modules!r}]; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_drill_child_loads_no_jax(tmp_path):
    import json

    from fl4health_tpu_torch.resilience.recovery import run_child

    spec = {"factory_file": str(ROOT / "tests" / "torch_recovery_factories.py"),
            "factory_name": "probe_modules", "n_rounds": 2, "ckpt_dir": str(tmp_path / "ckpt"),
            "out_dir": str(tmp_path / "out"), "kill": None, "device": "cpu"}
    res = run_child(spec, str(tmp_path / "spec.json"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads((tmp_path / "ckpt" / "loaded_modules.json").read_text()) == []
    assert [row["round"] for row in res.history] == [1, 2]
