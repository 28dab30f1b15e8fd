"""xff32_roofline_pct: the float crossfeed kernel's frozen bound
(``roofline_f32``) over its device time, a segment, in the traced
window."""

from .. import roofline_f32


def read(run):
    tr = run.trace
    if tr is None or not tr.segments:
        return None
    times = tr.kernel_times(lambda n: "xf_kernel" in n and "float" in n)
    if not times:
        return None
    bound = roofline_f32.segment_bounds(
        run.spec, run.shape["samples"], run.shape["lanes"],
        run.shape["packets"], "tenants" in run.shape)["xf_f32"]
    return 100.0 * bound / (sum(times) / tr.segments)
