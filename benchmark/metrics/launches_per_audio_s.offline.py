"""launches_per_audio_s.offline: kernels the traced window launched on the
card, over the audio seconds of the files it completed."""


def read(run):
    if run.trace is None or not run.served.done:
        return None
    return run.trace["kernels"] / run.served.audio_s
