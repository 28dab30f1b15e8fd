"""rtf: audio-seconds of real streams completed over the window's wall
seconds (padding lanes do not count): all the work over all the time."""

from ..trace import rate


def read(run):
    return rate(run.audio_s, run.window_s)
