"""Wall-clock timer (port of maskrcnn_tpu/utils/timer.py, after the
reference utils/timer.py). Callers wait for the card before ``toc`` where
the time should cover its work."""

import datetime
import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    @property
    def average_time(self):
        return self.total_time / self.calls if self.calls > 0 else 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average=True):
        self.diff = time.time() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.average_time if average else self.diff

    def total_time_str(self):
        return str(datetime.timedelta(seconds=int(self.total_time)))
