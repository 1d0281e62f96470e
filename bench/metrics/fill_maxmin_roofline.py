"""fill_maxmin_roofline.<mix>: `fill_maxmin`'s share of its roofline,
the least time its launches need (bytes at the HBM rate or operations at
the float32 peak, whichever is longer, per launch) over their device time
in the trace; in a partial trace, per launch on average."""
import numpy as np

from harness.roofline import bound_s, fill_maxmin_bytes, fill_maxmin_ops

KERNEL = "fill_maxmin_kernel"


def install(probe):
    """Record each launch's shape and its rounds tensor (read after the
    window, so the window has no extra sync)."""
    from repro_torch.kernels import waterfill
    calls = probe.data.setdefault("fill_maxmin", [])

    def make(orig):
        def fill_maxmin(con_ptr, ent_task, ent_w, active, caps, flows):
            rates, rounds = orig(con_ptr, ent_task, ent_w, active, caps,
                                 flows)
            calls.append((active.shape[0], active.shape[1], caps.shape[1],
                          ent_task.shape[-1], con_ptr.shape[0], rounds))
            return rates, rounds
        return fill_maxmin
    probe.wrap(waterfill, "fill_maxmin", make)


def read(run):
    calls = run.probe.data.get("fill_maxmin")
    if not calls or run.device is None:
        return None
    device_s, traced = run.device.kernel_seconds(KERNEL)
    if not traced or device_s <= 0:
        return None
    bound = 0.0
    for s, n, c, e, m, rounds in calls:
        total = int(rounds.sum())
        bound += bound_s(fill_maxmin_bytes(s, n, c, e, m),
                         fill_maxmin_ops(total, n, c, e))[0]
    return 100.0 * (bound / len(calls)) / (device_s / traced)
