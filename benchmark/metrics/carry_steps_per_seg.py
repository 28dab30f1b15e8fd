"""carry_steps_per_seg: the sequential steps of the block lowering's packet
carries (``dspi_tpu_torch.chain.mxu.COUNTS["carry_steps"]``, a count the
program keeps) over the window's segments: the loop length that each
segment's host dispatch walks through."""


def read(run):
    c = run.counters
    if "carry_steps" not in c or not run.segments:
        return None
    return c["carry_steps"] / run.segments
