"""unpack_ms_per_seg: the device milliseconds of the unpack, preamp and
volume staging (``dspi.unpack``) a segment, read as ``mix_ms_per_seg``
reads ``dspi.mix``."""

from .mix_ms_per_seg import span_ms


def read(run):
    return span_ms(run, "dspi.unpack")
