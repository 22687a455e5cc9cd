"""Windowed metric tracking (port copy of maskrcnn_tpu/utils/metric_logger.py)."""

from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    """Track a series of values and provide access to smoothed values over
    a window plus the global series average."""

    def __init__(self, window_size=20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        value = float(value)
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            "{}: {:.4f} ({:.4f})".format(name, meter.median, meter.global_avg)
            for name, meter in self.meters.items()
        )
