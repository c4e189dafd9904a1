"""Traced segments (the sum of `stats["rays"]`) of every accumulation that
the window finished, over the window's wall from its start to the end of
the last accumulation, in millions a second (host clock)."""


def value(w):
    return w["rays"] / w["wall_s"] / 1e6
