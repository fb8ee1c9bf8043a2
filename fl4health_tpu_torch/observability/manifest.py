"""Run manifest (counterpart of ``fl4health_tpu/observability/manifest.py``):
``config_hash``, the experiment identity a state checkpoint's frame binds
to. The rest of the manifest (versions, device facts) is not ported yet."""

from __future__ import annotations

import hashlib
import json
from typing import Any, Mapping


def config_hash(config: Mapping[str, Any]) -> str:
    """Short stable digest of a JSON-able config mapping (sorted keys,
    non-JSON leaves stringified): equal configs hash equal in either
    package and across processes."""
    canonical = json.dumps(config, sort_keys=True, default=str,
                           separators=(",", ":"))
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()[:16]
