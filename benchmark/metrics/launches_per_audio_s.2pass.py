"""launches_per_audio_s.2pass: kernels the traced window launched on the
card, over the audio seconds of the utterances whose final it sent."""


def read(run):
    if run.trace is None or run.served is None or run.served.audio_s <= 0:
        return None
    return run.trace["kernels"] / run.served.audio_s
