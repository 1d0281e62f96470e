"""device_idle.<mix>: the share of the traced window in which no
operation ran on the card (torch.profiler's CUPTI trace; the window is the
slice that the traffic file's `trace` sets).  One reader for every cell:
in `replan` the slice is a whole plan's cycle, so Alg. 2, the re-rank and
the certification are host-only stretches inside it."""


def read(run):
    if run.device is None or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
