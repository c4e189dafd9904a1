"""Seconds of the port's scene build (`build_scene_torch`: flattening, the
host BVH build, the copy to the device), host clock, in set-up."""


def read(rec):
    return rec["setup"]["scene_build_s"]
