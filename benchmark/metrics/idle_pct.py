"""idle_pct: the share of the traced window in which no device operation
ran (1 - the union of device-operation intervals / the window)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
