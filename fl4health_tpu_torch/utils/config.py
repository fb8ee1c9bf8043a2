"""YAML config loading and validation (counterpart of
``fl4health_tpu/utils/config.py``, a copy): ``load_config`` and
``check_config`` (``n_server_rounds`` required, positive-int checks),
``narrow_dict_type`` and the epochs-xor-steps helper. ``yaml`` is imported
only by ``load_config``: the card's machine has none, and nothing else here
needs it.
"""

from __future__ import annotations

from typing import Any, Mapping, TypeVar

T = TypeVar("T")


class InvalidConfigError(ValueError):
    pass


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    check_config(cfg)
    return cfg


def _positive_int(val: Any) -> bool:
    # bool is an int subclass; `n_server_rounds: true` must not validate
    return isinstance(val, int) and not isinstance(val, bool) and val > 0


def check_config(config: Mapping[str, Any]) -> None:
    """Required keys, types and positivity."""
    if not isinstance(config, Mapping):
        # yaml.safe_load of an empty file returns None; report it as the
        # config error it is, not a TypeError from the `in` below
        raise InvalidConfigError(
            f"config must be a mapping, got {type(config).__name__}"
        )
    if "n_server_rounds" not in config:
        raise InvalidConfigError("config missing required key n_server_rounds")
    if not _positive_int(config["n_server_rounds"]):
        raise InvalidConfigError("n_server_rounds must be a positive integer")
    for key in ("local_epochs", "local_steps", "batch_size"):
        if key in config and config[key] is not None:
            if not _positive_int(config[key]):
                raise InvalidConfigError(f"{key} must be a positive integer")


def narrow_dict_type(config: Mapping[str, Any], key: str, ty: type[T]) -> T:
    """Typed access with a clear error."""
    if key not in config:
        raise InvalidConfigError(f"config missing key {key}")
    val = config[key]
    if not isinstance(val, ty):
        raise InvalidConfigError(
            f"config[{key!r}] should be {ty.__name__}, got {type(val).__name__}"
        )
    return val


def epochs_steps_from_config(config: Mapping[str, Any]) -> tuple[int | None, int | None]:
    """Exactly one of local_epochs / local_steps."""
    epochs = config.get("local_epochs")
    steps = config.get("local_steps")
    if (epochs is None) == (steps is None):
        raise InvalidConfigError("specify exactly one of local_epochs / local_steps")
    return epochs, steps
