"""asr_ms_per_audio_s.offline: the program's `offline.asr` span (each
file's recognize_batch: front-end, forward, fetch, host decoding) in host
milliseconds over the audio seconds of the files the traced window
completed."""
from benchmark.lib import spans


def read(run):
    return spans.ms_per_audio_s(run, "offline.asr")
