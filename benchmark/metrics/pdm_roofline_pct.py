"""pdm_roofline_pct: the PDM kernel's frozen bound (``roofline.pdm_s``)
over its device time a call in the traced window."""

from .. import roofline


def read(run):
    tr = run.trace
    if tr is None:
        return None
    times = tr.kernel_times(lambda n: "pdm_kernel" in n)
    if not times:
        return None
    bound = roofline.pdm_s(run.shape["samples"], run.shape["lanes"])
    return 100.0 * bound / (sum(times) / len(times))
