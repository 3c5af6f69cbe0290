"""punc_ms_per_audio_s.offline: the program's `offline.punc` span (each
file's punctuation windows) in host milliseconds over the audio seconds
of the files the traced window completed; None without punctuation."""
from benchmark.lib import spans


def read(run):
    return spans.ms_per_audio_s(run, "offline.punc")
