"""The share of the reference's exact top 10 among the answers, on a
sample of the window's queries drawn from the seed."""


def read(rec):
    return rec.recall
