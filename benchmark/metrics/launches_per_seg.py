"""launches_per_seg: device operations (kernels, copies, sets) in the
traced window over the segments in it: the host's dispatch work."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not tr.segments:
        return None
    return tr.launches() / tr.segments
