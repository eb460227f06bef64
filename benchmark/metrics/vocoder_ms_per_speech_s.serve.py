"""Device ms of the vocoder (the range around the pipeline's vocoder) per
second of speech computed."""

from benchmark import readers, trace


def read(view):
    return readers.per_speech_s(view, trace.VOCODER)
