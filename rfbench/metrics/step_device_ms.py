"""step_device_ms: device-busy ms a block of the step, from the profiled
sub-window: every device activity but the host-to-device and
device-to-host copies (kernels, device-to-device copies, memsets), unioned."""

from rfbench.trace import D2H, H2D


def read(run):
    tr = run.trace
    if tr is None or not tr.window_s or not tr.block_count:
        return None
    busy = tr.busy_s(lambda n: not n.startswith((H2D, D2H)))
    return 1e3 * busy / tr.block_count if busy > 0 else None
