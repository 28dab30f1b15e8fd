"""cascade_sched_roofline_pct: ``cascade_roofline_pct`` on a packet
schedule: the Q28 cascade kernel's schedule-mode calls (the master call,
the envelope's packet ends read from the schedule, and the output call)
against the same frozen bound (``roofline.cascade_s`` at the segment's
samples and packets), read by ``cascade_roofline_pct`` itself.  A segment
of uniform packets, whose samples the packets divide, is no schedule:
nothing to read."""

from . import cascade_roofline_pct


def read(run):
    shape = run.shape
    if not shape or shape["samples"] % shape["packets"] == 0:
        return None
    return cascade_roofline_pct.read(run)
