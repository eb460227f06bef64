"""Device ms of stage 1 (frontend, conformer, heads: the range the
benchmark opens around the pipeline's model) per second of speech computed."""

from benchmark import readers, trace


def read(view):
    return readers.per_speech_s(view, trace.STAGE1)
