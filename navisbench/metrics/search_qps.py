"""Queries answered in the window over the window's length."""


def read(rec):
    if not rec.ops_of("search"):
        return None
    return rec.n_answered / rec.window_s
