"""Set-up: process start to the first timed operation (corpus, build,
warm-up, and in a checkout's first run the kernels' build)."""


def read(rec):
    return rec.setup_s
