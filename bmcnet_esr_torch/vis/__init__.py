"""Event renderers."""

from bmcnet_esr_torch.vis.events import EventVisualizer, render_event_count

__all__ = ["EventVisualizer", "render_event_count"]
