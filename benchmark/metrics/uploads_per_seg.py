"""uploads_per_seg: host-to-device copies a segment, from the program's
span record (``dspi_tpu_torch.runtime.telemetry.record``, kept while the
traced step's profiler records): the copies made through the program's
one upload site, summed over every span of a segment's summary, averaged
over the traced step's segments.  A program without the record reads
nothing."""


def summaries(run):
    """The record's summaries of the traced step's segments, or None."""
    if run.trace is None or run.trace.segments <= 0:
        return None
    from dspi_tpu_torch.runtime import telemetry

    record = getattr(telemetry, "record", None)
    if record is None:
        return None
    got = record(run.trace.segments)
    return got if len(got) == run.trace.segments else None


def read(run):
    got = summaries(run)
    if got is None:
        return None
    return sum(e["uploads"] for s in got for e in s.values()) / len(got)
