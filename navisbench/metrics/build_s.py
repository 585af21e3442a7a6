"""The host clock around ``Engine.build``, ended by a sync."""


def read(rec):
    return rec.build_s
