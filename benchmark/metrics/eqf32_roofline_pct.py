"""eqf32_roofline_pct: the float cascade kernel's frozen bound
(``roofline_f32``) over its device time, a segment: the master call
(loudness rows, master bands and the leveller envelope of both channels)
and the output call (every enabled output's bands), summed, over the
summed time of the kernel's launches in the traced window a segment.
Per-lane coefficients (a multi-tenant cell) count per-lane bytes."""

from .. import roofline_f32


def read(run):
    tr = run.trace
    if tr is None or not tr.segments:
        return None
    times = tr.kernel_times(lambda n: "cascade_kernel" in n
                            and "float" in n)
    if not times:
        return None
    bound = roofline_f32.segment_bounds(
        run.spec, run.shape["samples"], run.shape["lanes"],
        run.shape["packets"], "tenants" in run.shape)["eq_f32"]
    return 100.0 * bound / (sum(times) / tr.segments)
