"""Process start to the first timed batch: imports, kernel builds, data,
index build, the copy to the card and the warm-up batch."""


def read(rec):
    return rec.setup_s
