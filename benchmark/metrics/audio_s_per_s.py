"""audio_s_per_s: the audio seconds of the files completed in the window
over the window (host clock), from the first file's start to the end of
the last file started before the window's length had passed."""


def read(run):
    served = run.served
    if served is None or served.window_s <= 0 or not served.done:
        return None
    return served.audio_s / served.window_s
