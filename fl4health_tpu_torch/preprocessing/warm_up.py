"""Warm-start weight injection with name-mapping surgery (counterpart of
``fl4health_tpu/preprocessing/warm_up.py``): copy a pretrained model's
leaves into a target model wherever the keys (after an optional prefix
rewrite) and the shapes match; every other leaf keeps its fresh init.

Keys are dotted tree paths, JAX's namespace (``"Dense_0.kernel"``): a port
``Params`` key ``"a/b/c"`` reads as ``"a.b.c"``, so one file warm-starts both
packages alike. A mapping may hold partial prefixes: the longest-prefix
match rewrites the head of the path.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.core.types import Params

logger = logging.getLogger(__name__)


def flat_paths(tree: Any) -> dict[str, Any]:
    """``{dotted path: leaf}`` of a tree as JAX's warm-up names it: dict
    keys (a ``"a/b"`` key as two parts), sequence indices and dataclass
    fields joined with dots."""
    out: dict[str, Any] = {}

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}".replace("/", ".") if prefix else str(k).replace("/", "."))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}" if prefix else str(i))
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{prefix}.{f.name}" if prefix else f.name)
        else:
            out[prefix] = node

    walk(tree, "")
    return out


class WarmedUpModule:
    """Pretrained-weight injection."""

    def __init__(self, pretrained_params: Any, weights_mapping: dict[str, str] | None = None):
        self.pretrained = flat_paths(pretrained_params)
        self.weights_mapping = weights_mapping

    def get_matching_component(self, key: str) -> str | None:
        """Rewrite a target key into the pretrained namespace by its longest
        mapped prefix (None where no prefix is mapped)."""
        if self.weights_mapping is None:
            return key
        components = key.split(".")
        prefix = ""
        for i, component in enumerate(components):
            prefix = component if i == 0 else f"{prefix}.{component}"
            if prefix in self.weights_mapping:
                # lstrip: an empty replacement ({"global_model": ""}) gives
                # "Dense_0.kernel", not ".Dense_0.kernel"
                return (self.weights_mapping[prefix] + key[len(prefix):]).lstrip(".")
        return None

    def load_from_pretrained(self, params: Params) -> Params:
        """``params`` (a ``Params`` dict) with every matchable leaf replaced
        by its pretrained counterpart, a tensor on the leaf's device in the
        file's dtype."""
        matched = 0
        out = {}
        for name, leaf in params.items():
            key = name.replace("/", ".")
            pretrained_key = self.get_matching_component(key)
            if pretrained_key is None or pretrained_key not in self.pretrained:
                out[name] = leaf
                continue
            candidate = self.pretrained[pretrained_key]
            if tuple(candidate.shape) != tuple(leaf.shape):
                logger.warning("state not loaded, mismatched shapes %s -> %s for %s",
                               tuple(leaf.shape), tuple(candidate.shape), key)
                out[name] = leaf
                continue
            matched += 1
            if not isinstance(candidate, torch.Tensor):
                candidate = torch.from_numpy(np.array(candidate))
            out[name] = candidate.to(leaf.device)
        logger.info("%d/%d states were matched.", matched, len(params))
        return out
