"""Reporters: metric and event sinks (counterpart of
``fl4health_tpu/reporting/base.py``).

``BaseReporter`` with ``initialize``/``report(data, round, epoch, step)``/
``shutdown``; ``ReportsManager`` fans out to several; ``JsonReporter``
accumulates the JAX package's nested ``{..., "rounds": {r: {...}}}`` dict
and dumps it as JSON on shutdown, so readers of a JAX run's report read a
port run's too; ``WandBReporter`` logs JAX's payloads to wandb, imported
only when it initializes (the card's machine has none: it then reports
nothing, with a warning).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import uuid
from typing import Any, Mapping, Sequence

import numpy as np

from fl4health_tpu_torch.core.io import atomic_write

logger = logging.getLogger(__name__)

# Arrays up to this many elements serialize as JSON lists; larger ones are
# summarized (a reporter dict is a log line, not a checkpoint format).
_MAX_ARRAY_ELEMENTS = 64


class BaseReporter:
    def initialize(self, **kwargs: Any) -> None:
        pass

    def report(
        self,
        data: Mapping[str, Any],
        round: int | None = None,
        epoch: int | None = None,
        step: int | None = None,
    ) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class ReportsManager:
    """Fan-out to a set of reporters."""

    def __init__(self, reporters: Sequence[BaseReporter] = ()):
        self.reporters = list(reporters)

    def initialize(self, **kwargs):
        for r in self.reporters:
            r.initialize(**kwargs)

    def report(self, data, round=None, epoch=None, step=None):
        for r in self.reporters:
            r.report(data, round=round, epoch=epoch, step=step)

    def shutdown(self):
        for r in self.reporters:
            r.shutdown()


class JsonReporter(BaseReporter):
    """Accumulate a nested dict ``{metadata..., rounds: {r: {...}}}`` and
    dump it to ``<output_folder>/<run_id>.json`` on shutdown."""

    def __init__(self, output_folder: str = ".", run_id: str | None = None):
        self.run_id = run_id or str(uuid.uuid4())
        self.output_folder = output_folder
        self.data: dict = {"rounds": {}}

    def report(self, data, round=None, epoch=None, step=None):
        if round is None:
            self.data.update(_jsonify(data))
        else:
            rd = self.data["rounds"].setdefault(str(round), {})
            if epoch is not None:
                rd = rd.setdefault("epochs", {}).setdefault(str(epoch), {})
            if step is not None:
                rd = rd.setdefault("steps", {}).setdefault(str(step), {})
            rd.update(_jsonify(data))

    def dump(self) -> str:
        # atomic publish: a crash mid-write must never leave a truncated
        # JSON at the published path
        path = os.path.join(self.output_folder, f"{self.run_id}.json")
        with atomic_write(path) as f:
            json.dump(self.data, f, indent=2)
        return path

    def shutdown(self):
        self.dump()


def _jsonify(data: Mapping[str, Any]) -> dict:
    out = {}
    for k, v in data.items():
        if isinstance(v, Mapping):
            out[k] = _jsonify(v)
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        elif isinstance(v, datetime.datetime):
            out[k] = v.isoformat()
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            # numpy arrays and tensors: 0-d -> a Python scalar, small ->
            # nested lists, big -> a shape/dtype summary. The size gate reads
            # the shape only, so a big device tensor is never copied to the
            # host just to be summarized away
            shape = tuple(v.shape)
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if shape and size > _MAX_ARRAY_ELEMENTS:
                out[k] = f"array(shape={shape}, dtype={v.dtype})"
            else:
                arr = np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
                out[k] = arr.item() if arr.ndim == 0 else arr.tolist()
        elif isinstance(v, (list, tuple)):
            out[k] = [_jsonify({"_": item})["_"] for item in v]
        else:
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                out[k] = str(v)
    return out


class WandBReporter(BaseReporter):
    """wandb sink. ``wandb`` is imported in ``initialize``; where it is
    absent or its init fails, the reporter drops every report and says so
    once, with a warning."""

    def __init__(self, project: str = "fl4health_tpu", **init_kwargs):
        self.project = project
        self.init_kwargs = init_kwargs
        self._run = None

    def initialize(self, **kwargs):
        try:
            import wandb  # type: ignore

            self._run = wandb.init(project=self.project, **self.init_kwargs)
        except Exception as e:
            logger.warning("WandBReporter disabled (wandb init failed: %s: %s); "
                           "reports will be dropped.", type(e).__name__, e)
            self._run = None

    def report(self, data, round=None, epoch=None, step=None):
        if self._run is None:
            return
        payload = dict(_jsonify(data))
        if round is not None:
            payload["round"] = round
        self._run.log(payload)

    def shutdown(self):
        if self._run is not None:
            self._run.finish()
