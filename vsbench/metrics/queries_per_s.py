"""Every query answered in the window over the window's seconds."""


def read(rec):
    return rec.queries / rec.window_s
