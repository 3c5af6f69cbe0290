"""vad_ms_per_audio_s.offline: the program's `offline.vad` span (the
whole VAD segmentation of each file) in host milliseconds over the audio
seconds of the files the traced window completed."""
from benchmark.lib import spans


def read(run):
    return spans.ms_per_audio_s(run, "offline.vad")
