"""Frames a second of the offline cells: every frame of the window's
whole jobs over all of the window's wall time, corrections included."""

def read(rec):
    for i, j in enumerate(rec.jobs):
        rec.notes.append(f"job {i}: {j.frames} frames in {j.wall_s:.3f} s, {j.keyframes} "
                         f"keyframes, {j.loop_events} loop events, {j.corrections} "
                         f"corrections, {j.lost} lost")
    return rec.frames / rec.window_s if rec.jobs and rec.window_s > 0 else None
