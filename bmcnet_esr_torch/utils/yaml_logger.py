"""Structured YAML results writer (counterpart of
``bmcnet_esr_tpu/utils/yaml_logger.py``; PyYAML is imported when a file is
written, so the package imports without it)."""

from __future__ import annotations

from typing import Any, Dict


class YamlResultLogger:
    def __init__(self, path: str):
        self.path = path
        self._doc: Dict[str, Any] = {}

    def log_info(self, info: str) -> None:
        self._doc.setdefault("info", []).append(info)

    def log_dict(self, data: Dict, name: str) -> None:
        self._doc[name] = _plain(data)
        self.flush()

    def flush(self) -> None:
        import yaml

        with open(self.path, "w") as f:
            yaml.safe_dump(self._doc, f, default_flow_style=False, sort_keys=False)

    def close(self) -> None:
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _plain(obj):
    """Recursively convert numpy / torch scalars to plain python types."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return obj
