"""File inference: model loading and the chunked recurrent rollout."""

from bmcnet_esr_torch.inference.engine import InferenceEngine, load_model_for_inference

__all__ = ["InferenceEngine", "load_model_for_inference"]
