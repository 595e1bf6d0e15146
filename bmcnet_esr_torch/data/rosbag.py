"""ROS bag -> event h5 conversion (reference
``generate_dataset/tools/rosbag_to_h5.py``).

Counterpart of ``bmcnet_esr_tpu/data/rosbag.py``.  It needs the
``rosbag`` / ``rospy`` stack, which is imported on use and raises a clear
``ImportError`` without it, so the rest of the package imports.  Event
topics give ``(x, y, t, p)`` with ``p`` mapped to {-1, +1}; image topics are
stored with their timestamps; timestamps stay absolute (float64 seconds).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bmcnet_esr_torch.data.packager import MultiScaleEventPackager


def rosbag_to_h5(
    bag_path: str,
    out_path: str,
    event_topic: str,
    image_topic: Optional[str] = None,
    sensor_resolution: Optional[Sequence[int]] = None,
    prefix: str = "ori",
    chunk: int = 500_000,
) -> str:
    try:
        import rosbag
    except ImportError as e:
        raise ImportError(
            "rosbag_to_h5 requires the ROS python stack (rosbag). "
            "Install ros-<distro>-rosbag + cv_bridge, or convert the bag to "
            "txt and use `python -m bmcnet_esr_torch.cli.generate txt`."
        ) from e

    bag = rosbag.Bag(bag_path, "r")
    with MultiScaleEventPackager(out_path) as pk:
        got_res = sensor_resolution is not None
        if got_res:
            pk.set_sensor_resolution(sensor_resolution)
        xs, ys, ts, ps = [], [], [], []

        def flush():
            if xs:
                pk.append_events(prefix, xs, ys, ts, ps)
                xs.clear(); ys.clear(); ts.clear(); ps.clear()

        for _, msg, _ in bag.read_messages(topics=[event_topic]):
            if not got_res and hasattr(msg, "height"):
                pk.set_sensor_resolution([msg.height, msg.width])
                got_res = True
            for e in msg.events:
                xs.append(e.x)
                ys.append(e.y)
                ts.append(e.ts.to_sec())
                ps.append(1.0 if e.polarity else -1.0)
            if len(xs) >= chunk:
                flush()
        flush()

        if image_topic is not None:
            from cv_bridge import CvBridge

            bridge = CvBridge()
            for _, msg, _ in bag.read_messages(topics=[image_topic]):
                img = bridge.imgmsg_to_cv2(msg)
                pk.append_image("ori", np.asarray(img), msg.header.stamp.to_sec())
            pk.annotate_image_event_indices("ori", prefix)
    bag.close()
    return out_path
