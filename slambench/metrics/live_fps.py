"""Frames a second of the live session: frames handed in over the
window's wall time."""

def read(rec):
    return rec.frames / rec.window_s if rec.frame_ms and rec.window_s > 0 else None
