"""YAML recipe parsing and run directories.

Counterpart of ``bmcnet_esr_tpu/training/config.py`` (the reference
``config/parser.py``): loads a YAML recipe (anchors resolved by PyYAML,
imported when a file is read), applies CLI overrides addressed by
``;``-separated paths (``parser.py:93-112``), creates
``<output>/models|logs/<experiment>/<runid>``, archives the effective config
and sets up logging.  Where PyYAML is not installed the archived
``config.yml`` is written as JSON, which YAML reads as well.
"""

from __future__ import annotations

import copy
import datetime
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

from bmcnet_esr_torch.utils.logging import setup_logging


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def set_by_path(tree: Dict[str, Any], target: str, value: Any) -> None:
    """Set ``a;b;c`` -> tree['a']['b']['c'] = value (``parser.py:103-107``)."""
    keys = target.split(";")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _dump_config(config: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        try:
            import yaml
        except ImportError:
            json.dump(config, f, indent=2)
            return
        yaml.safe_dump(config, f, default_flow_style=False, sort_keys=False)


class RunConfig:
    """Parsed recipe + run directories + archived effective config."""

    def __init__(
        self,
        config: Dict[str, Any],
        runid: Optional[str] = None,
        overrides: Sequence[Tuple[str, Any]] = (),
        make_dirs: bool = True,
    ):
        self.config = copy.deepcopy(config)
        for target, value in overrides:
            set_by_path(self.config, target, value)

        self.experiment = self.config.get("experiment", "exp")
        self.runid = runid or datetime.datetime.now().strftime("%m%d_%H%M%S")
        output = self.config.get("trainer", {}).get("output_path", "runs/")

        self.save_dir = os.path.join(output, "models", self.experiment, self.runid)
        self.log_dir = os.path.join(output, "logs", self.experiment, self.runid)
        if make_dirs:
            os.makedirs(self.save_dir, exist_ok=True)
            os.makedirs(self.log_dir, exist_ok=True)
            _dump_config(self.config, os.path.join(self.save_dir, "config.yml"))
            setup_logging(self.log_dir)

    @classmethod
    def from_file(cls, path: str, runid=None, overrides=(), make_dirs=True) -> "RunConfig":
        return cls(load_yaml(path), runid=runid, overrides=overrides, make_dirs=make_dirs)

    def __getitem__(self, key: str) -> Any:
        return self.config[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self.config.get(key, default)
