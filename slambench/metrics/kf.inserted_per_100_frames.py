"""Keyframes ever inserted (`kf_pose_at_insert`) per 100 of the
window's frames: a count of the keyframe branch's work."""

from slambench.readers import job_sum


def read(rec):
    return job_sum(rec, "keyframes", 100.0)
