"""Run one cell of the benchmark once, in this process:

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. It
sets up (the port, its kernels, the scene's frames on the card, the
vocabulary, the warm-up), measures for `--seconds`, judges every answer
of the window against the plain reference, and prints one JSON line last
on standard output: the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics from a profiled sub-window after the window with
`--trace 1`. Without the cards it asks for it exits 2 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Top-level module names that must not be loaded in the process that
# prints the result: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_ssd_semantic_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float):
    """Set up, warm up, measure, and (with `traced`) profile the
    sub-window. Returns (record, answers, scene, peak memory bytes)."""
    import torch

    from slambench import drive, spec
    from slambench.record import Record
    from slambench.roofline import ShapeRecorder
    from slambench.scene import synthetic

    conf, traffic = cell["config"], cell["traffic"]
    mode = traffic["mode"]
    rec = Record(cell=cell["workload"]["name"],
                 mode="live" if mode == "live_session" else "offline")
    vocab_path = drive.vocabulary_file(conf["vocabulary"], spec.ROOT / "build" / "slambench")
    cfg = drive.slam_config(conf["slam"], vocab_path)
    scene = synthetic.build(conf["scene"])
    if mode == "offline_jobs":
        scene = scene.prefix(int(conf["offline"]["job_frames"]))
    elif mode != "live_session":
        raise ValueError(f"unknown traffic mode {mode!r}")
    renders = [drive.render_scene(scene, cfg.camera, seed, device, k)
               for k in range(int(traffic.get("realizations", 1)))]
    _sync(device)
    if device.type == "cuda":
        # The peak is the system's: the renderer's scratch (a quarter of
        # the card's free memory) is the benchmark's.
        torch.cuda.reset_peak_memory_stats(device)
    shapes = ShapeRecorder()
    if mode == "offline_jobs":
        jobs = drive.OfflineJobs(cfg, vocab_path, renders, int(conf["offline"]["segment_len"]),
                                 device)
        with shapes.recording():
            for _ in range(int(traffic["warmup_jobs"])):
                jobs.run()
    else:
        grays, depths = renders.pop()
        session = drive.LiveSession(cfg, grays.cpu().numpy(), depths.cpu().numpy(),
                                    float(traffic["fps"]), device)
        del grays, depths
        with shapes.recording():
            drive.warm_live(session, traffic)
    _sync(device)
    rec.shapes = shapes.shapes
    rec.setup_s = time.perf_counter() - t_start

    if mode == "offline_jobs":
        answers = drive.run_offline(rec, jobs, scene, seconds)
    else:
        first = drive.run_live(rec, session, seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        if mode == "offline_jobs":
            answers.append(drive.trace_offline(rec, jobs, scene))
        else:
            drive.trace_live(rec, session, traffic)
    if mode == "live_session":
        answers = [session.answers(scene, first)]
    return rec, answers, scene, peak


def _num(v):
    """A JSON number as measured, or a string where it is not finite."""
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def result(rec, metrics, correct: bool, attempted: int, failed: int, rows, device: dict) -> dict:
    """The last line: the metrics `metrics` [(entry, reader)] that read
    something, the device (with the traced sub-window's busy and window
    seconds), the breakdown of a traced run, and each number compared
    beside its limit under `check`, last."""
    from slambench.trace import breakdown

    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": {},
           "device": dict(device)}
    for m, mod in metrics:
        v = mod.read(rec)
        if v is not None:
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if rec.trace is not None:
        out["device"]["busy_s"] = rec.trace.busy_s
        out["device"]["window_s"] = rec.trace.window_s
        out["breakdown"] = breakdown(rec.trace)
    out["check"] = {name: {"value": _num(v), "limit": lim} for name, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slambench import check, spec

    bench = spec.benchmark()
    cell = spec.load_cell(bench, args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # load from one process with few threads
    device = torch.device("cuda", 0)
    limit = power_limit()
    rec, answers, scene, peak = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                                        T_START)
    rec.power_limit = limit
    found = forbidden_modules()
    if found:
        print(f"slambench: the process loaded {found}, which the port must not load",
              file=sys.stderr)
        return 3

    values = check.numbers(answers, scene)
    attempted = rec.frames + (rec.trace.frames if rec.trace else 0)
    failed = rec.failed + rec.trace_failed
    correct, rows = check.decide(values, cell["limits"], attempted, failed)
    out = result(rec, cell["per_layer" if args.trace else "end_to_end"], correct, attempted,
                 failed, rows, {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                                "count": chips, "memory_peak_bytes": int(peak)})
    print(f"slambench: {rec.cell} seed {args.seed}: {len(rec.jobs) or rec.frames} "
          f"{'jobs' if rec.jobs else 'frames'} in {rec.window_s:.3f} s after {rec.setup_s:.3f} s "
          f"of set-up; card {limit}", file=sys.stderr)
    for note in rec.notes + [f"readings {json.dumps({k: _num(v) for k, v in values.items()})}"]:
        print("slambench: " + note, file=sys.stderr)
    for name, v, lim in rows:
        print(f"check {name} {_num(v)} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
