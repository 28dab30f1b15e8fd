"""setup_s: from the start of the process to the first timed operation:
imports, the card's context, the program's build of the cell (kernels
built or loaded), the inputs, and one warm segment or batch."""


def read(run):
    return run.setup_s
