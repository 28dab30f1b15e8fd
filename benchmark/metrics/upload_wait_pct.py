"""upload_wait_pct: the host seconds spent in the program's uploads (the
copy and the stream sync that follows a pageable copy), over the host
seconds of ``dspi.segment``, in %, summed over the traced step's
segments in the program's span record."""

from .uploads_per_seg import summaries


def read(run):
    got = summaries(run)
    if got is None or any("dspi.segment" not in s for s in got):
        return None
    wait = sum(e["upload_s"] for s in got for e in s.values())
    return 100.0 * wait / sum(s["dspi.segment"]["host_s"] for s in got)
