"""Event and image ops of the inference and training paths (JAX layouts at every public
function: events ``[..., 4, N]``, count images ``[..., H, W, 2]``)."""

from bmcnet_esr_torch.ops.batch import (
    batch_counts_from_compact,
    batch_events_to_counts,
    compact_events,
    counts_from_batch,
    sliding_pairs,
)
from bmcnet_esr_torch.ops.encodings import (
    events_polarity_mask,
    events_to_channels,
    events_to_image,
    normalize_event_times,
)
from bmcnet_esr_torch.ops.resize import resize_bicubic, resize_bilinear, upsample_bilinear
from bmcnet_esr_torch.ops.shuffle import pixel_shuffle, pixel_unshuffle
from bmcnet_esr_torch.ops.warp import grid_sample_bilinear

__all__ = [
    "batch_counts_from_compact", "batch_events_to_counts", "compact_events",
    "counts_from_batch", "sliding_pairs", "events_polarity_mask", "events_to_channels",
    "events_to_image", "normalize_event_times", "resize_bicubic", "resize_bilinear",
    "upsample_bilinear", "pixel_shuffle", "pixel_unshuffle", "grid_sample_bilinear",
]
