"""File inference (the chunked recurrent rollout), live serving (streams,
the slot pool and the TCP daemon) and serving bundles (``torch.export``).

Names load on first use, so that a consumer of a serving bundle
(``ExportedStream``) imports neither the models nor the engine."""

import importlib

_HOMES = {
    "engine": ("InferenceEngine", "load_model_for_inference"),
    "server": ("EventSRClient", "EventSRServer"),
    "streaming": ("WIRE_MODES", "PredFetch", "StreamingSR", "StreamPool", "assemble_fetch",
                  "pad_window", "pad_window_compact", "serving_state", "valid_polarity",
                  "wire_decode"),
    "export": ("ExportedStream", "export_serving_bundle"),
}
_HOME_OF = {name: mod for mod, names in _HOMES.items() for name in names}

__all__ = sorted(_HOME_OF)


def __getattr__(name: str):
    mod = _HOME_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
