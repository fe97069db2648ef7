"""Config layer: YAML config tree + experiment overlays + derived-value
resolvers; the port of `basd_tpu/config.py`.

* a base ``config.yaml`` composed with an optional ``experiment=<name>``
  overlay whose keys merge into the global tree,
* dotted-path CLI overrides (``training.num_epochs=10``), their values
  parsed as YAML,
* ``${...}`` resolvers computed from dataset metadata at resolution time:
  ``${num_classes:ds}``, ``${label_smoothing:ds}`` (= 1/num_classes) and
  ``${eval_crop_ratio:img,patch}`` (= img/(img+2*patch)),
* a resolved-config snapshot written into the run dir, the contract
  between train and eval.

The config files in `basd_tpu_torch/configs/` are byte copies of the JAX
package's. The YAML is read and written by `utils.yaml_subset`, so the port
needs no PyYAML; a snapshot either package writes loads in the other.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping

from basd_tpu_torch.utils import yaml_subset

_CONFIG_DIR = Path(__file__).parent / "configs"

_RESOLVER_RE = re.compile(r"^\$\{(\w+):(.*)\}$")
_INTERP_RE = re.compile(r"^\$\{([\w.]+)\}$")


class Config(dict):
    """Nested dict with attribute access (config.model.vit.img_size)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o: Any) -> Any:
            if isinstance(o, Mapping):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


# --------------------------------------------------------------------------
# Resolvers
# --------------------------------------------------------------------------

_RESOLVERS: dict[str, Callable[..., Any]] = {}


def register_resolver(name: str, fn: Callable[..., Any]) -> None:
    _RESOLVERS[name] = fn


def _coerce(token: str) -> Any:
    token = token.strip()
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return token


def register_default_resolvers() -> None:
    # imported here so config.py does not import the data layer at import
    # time
    from basd_tpu_torch.data.datasets import dataset_info

    register_resolver("num_classes", lambda ds: dataset_info(ds)["num_classes"])
    register_resolver(
        "label_smoothing", lambda ds: 1.0 / dataset_info(ds)["num_classes"]
    )
    register_resolver(
        "eval_crop_ratio", lambda img, patch: img / (img + 2 * patch)
    )


# --------------------------------------------------------------------------
# Composition
# --------------------------------------------------------------------------


def _deep_merge(base: dict, overlay: Mapping) -> dict:
    for key, value in overlay.items():
        if (
            key in base
            and isinstance(base[key], Mapping)
            and isinstance(value, Mapping)
        ):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _set_dotted(tree: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get_dotted(tree: Mapping, dotted: str) -> Any:
    node: Any = tree
    for k in dotted.split("."):
        node = node[k]
    return node


def _parse_override_value(raw: str) -> Any:
    return yaml_subset.load(raw)


def _read_yaml(path: Path | str) -> Any:
    with open(path) as f:
        return yaml_subset.load(f.read())


def _resolve_node(node: Any, root: Mapping) -> Any:
    if isinstance(node, str):
        m = _RESOLVER_RE.match(node)
        if m:
            name, argstr = m.group(1), m.group(2)
            if name not in _RESOLVERS:
                raise KeyError(f"unknown resolver '{name}' in '{node}'")
            args = []
            for tok in argstr.split(","):
                tok = tok.strip()
                interp = _INTERP_RE.match(tok)
                if interp:
                    args.append(_resolve_node(_get_dotted(root, interp.group(1)), root))
                else:
                    args.append(_coerce(tok))
            return _RESOLVERS[name](*args)
        m = _INTERP_RE.match(node)
        if m:
            return _resolve_node(_get_dotted(root, m.group(1)), root)
        return node
    if isinstance(node, Mapping):
        return {k: _resolve_node(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_node(v, root) for v in node]
    return node


def _apply_overrides(tree: dict, overrides: Iterable[str]) -> None:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not of the form key=value")
        key, _, raw = ov.partition("=")
        _set_dotted(tree, key, _parse_override_value(raw))


def compose_config(
    overrides: Iterable[str] = (),
    *,
    config_dir: Path | str | None = None,
    config_name: str = "config",
) -> Config:
    """Compose base config + optional experiment overlay + dotted overrides
    (``experiment=basd_cifar100 training.num_epochs=10``)."""
    config_dir = Path(config_dir) if config_dir is not None else _CONFIG_DIR
    tree: dict = _read_yaml(config_dir / f"{config_name}.yaml")

    experiment = None
    rest: list[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not of the form key=value")
        key, _, raw = ov.partition("=")
        if key == "experiment":
            experiment = raw
        else:
            rest.append(ov)

    if experiment:
        _deep_merge(tree, _read_yaml(config_dir / "experiment" / f"{experiment}.yaml"))

    _apply_overrides(tree, rest)
    register_default_resolvers()
    return Config.wrap(_resolve_node(tree, tree))


def compose_from_snapshot(
    path: Path | str, overrides: Iterable[str] = ()
) -> Config:
    """Load a run's config snapshot and apply dotted CLI overrides. The
    snapshot carries the teacher-derived student architecture
    (`model.arch_overrides`) and is resolved already, so no resolver pass
    runs here."""
    tree: dict = _read_yaml(path)
    _apply_overrides(tree, overrides)
    return Config.wrap(tree)


def save_config(config: Config, path: Path | str) -> None:
    """Snapshot the fully-resolved config (train/eval contract)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(yaml_subset.dump(config.to_dict()))


def load_config(path: Path | str) -> Config:
    return Config.wrap(_read_yaml(path))
