"""wire_ms_per_seg: the device milliseconds of the wire stage (``dspi.wire``:
u16 peaks, wire words, the PDM modulator and its words' sum) a segment,
read as ``mix_ms_per_seg`` reads ``dspi.mix``."""

from .mix_ms_per_seg import span_ms


def read(run):
    return span_ms(run, "dspi.wire")
