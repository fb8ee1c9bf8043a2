"""The device probe (counterpart of ``fl4health_tpu/utils/tpu_probe.py``; the
name is kept so a reader finds it): is the card there.

A stuck CUDA runtime or device can hang a process at device init, so
liveness is decided by a subprocess probe under a timeout. The probe child
imports torch (no JAX) and prints the platform behind a sentinel-prefixed
line, so trailing banners or info messages on stdout can never be misread
as a platform string: ``gpu`` where ``torch.cuda.is_available()``, else
``cpu``. A timeout reads ``down``, a crash ``error: <stderr tail>``.
"""

from __future__ import annotations

import json
import subprocess
import sys

_SENTINEL = "FL4HEALTH_PLATFORM="

_PROBE_SRC = (
    "import torch; "
    f"print('{_SENTINEL}' + ('gpu' if torch.cuda.is_available() else 'cpu'))"
)


def probe_platform(timeout_s: int, cwd: str | None = None) -> str:
    """Return the live platform string, 'down' on timeout (a hung device
    init), or 'error: <stderr tail>' when the probe child crashed outright —
    a broken environment (missing package, bad path) must stay
    distinguishable from a dead device in the logs."""
    try:
        res = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            capture_output=True, text=True, timeout=timeout_s, cwd=cwd,
        )
    except subprocess.TimeoutExpired:
        return "down"
    if res.returncode != 0:
        tail = res.stderr.strip().splitlines()
        return f"error: {tail[-1][:200] if tail else f'rc={res.returncode}'}"
    for line in reversed(res.stdout.splitlines()):
        if line.startswith(_SENTINEL):
            return line[len(_SENTINEL):].strip()
    return ""


def is_accelerator(platform: str) -> bool:
    """Any live platform that is not the CPU is the card."""
    return platform not in ("", "cpu", "down") and not platform.startswith("error")


def last_json_line(text: str) -> dict | None:
    """Parse the LAST valid JSON object line from child stdout (later lines
    supersede earlier partial/progress output)."""
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None
