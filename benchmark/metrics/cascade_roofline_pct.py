"""cascade_roofline_pct: the Q28 cascade kernel's frozen bound over its
device time, a segment: the master call (two channels, the loudness rows
and the leveller envelope) and the output call (every enabled output),
summed, over the summed time of the kernel's calls in the traced window
a segment.  Per-lane coefficients (a multi-tenant cell) take the
``lane_cf`` counts."""

from .. import roofline


def read(run):
    tr = run.trace
    if tr is None or not tr.segments:
        return None
    times = tr.kernel_times(lambda n: "cascade_kernel" in n
                            or "lane_kernel" in n)
    if not times:
        return None
    dev = run.spec["device"]
    nb = len(dev["eq"][0])
    loud, env = dev["loudness"]["enabled"], dev["leveller"]["enabled"]
    n_out = sum(1 for o in dev["outputs"] if o["enabled"])
    T, B, npkt = (run.shape["samples"], run.shape["lanes"],
                  run.shape["packets"])
    lane = "tenants" in run.shape
    bound = (roofline.cascade_s(2, nb, loud, env, T, B, npkt, lane)
             + roofline.cascade_s(n_out, nb, False, False, T, B, npkt, lane))
    return 100.0 * bound / (sum(times) / tr.segments)
