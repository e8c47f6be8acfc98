"""How `correct` is decided: every answer of the window judged by the
plain reference (`reference/truth.py`), each number against the cell's
limit (`cells/<cell>.json`)."""

from __future__ import annotations

from slambench.reference import truth


def numbers(answers: list, scene) -> dict:
    """The widest reading of each number over the window's jobs (one
    entry for a live session)."""
    out: dict = {}
    for a in answers:
        got = truth.judge(a["T_cw"], a["W_true"], a["kf_T_cw"], a["kf_W_true"], a["points"],
                          a["point_kf"], scene.room, scene.boxes,
                          kf_moving=a["kf_moving"], first=a.get("first", 0))
        for k, v in got.items():
            out[k] = max(out.get(k, v), v)
    return out


def decide(values: dict, limits: dict, attempted: int, failed: int):
    """(correct, [(name, value, limit)]): correct where something was
    attempted, no frame failed and every number lies at or under its
    limit (a number that is not a number fails)."""
    rows = [("failed_frames", failed, 0)]
    rows += [(k, values.get(k, float("nan")), limits[k]) for k in sorted(limits)]
    ok = attempted > 0 and all(v <= lim for _, v, lim in rows)
    return ok, rows
