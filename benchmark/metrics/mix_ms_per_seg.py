"""mix_ms_per_seg: the device milliseconds of the matrix mix
(``dspi.mix``) a segment: the span's CUDA events on the segment's stream
in the program's span record, from its first operation to its last (idle
between them included), averaged over the traced step's segments."""

from .uploads_per_seg import summaries


def span_ms(run, name: str):
    """``name``'s device ms a segment in the record; None where a segment
    did not open it or ran on no card."""
    got = summaries(run)
    if got is None:
        return None
    secs = [s[name]["device_s"] if name in s else None for s in got]
    if any(v is None for v in secs):
        return None
    return 1e3 * sum(secs) / len(secs)


def read(run):
    return span_ms(run, "dspi.mix")
