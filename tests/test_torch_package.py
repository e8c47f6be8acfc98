"""Package rules of the PyTorch port: it loads neither JAX, Triton nor the
JAX package, and its import loads no matplotlib (only the viewers need
it); its entry points (the Tracker, the whole-sequence scan and
segmented runner, `SlamSystem`, the detector, the occupancy maps, the
batched consumer, registration and undistortion, the live app and the web
viewer) run on the card unless asked for the CPU, and so does
`parallel/mesh.make_mesh`, which also needs a process group; `SlamSystem`
takes only a (kf, pt) device mesh and runs each other part on the CPU when
asked (the dense map, the stereo and monocular front ends, map and
occupancy persistence); the dynamic masks (the Tracker's `dynamic.enable_*`, the
scan's and the segmented runner's `use_flow` and `use_geom`), loop
closing and relocalization, together or alone, are accepted. The port has
every public name of the JAX package at the same path, or a counterpart
named in `RENAMED`."""

import ast
import importlib
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import DynamicConfig, LoopConfig, SlamConfig
from _torch_threads import _few_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "orb_slam2_ssd_semantic_tpu_torch"
JAX_PKG = ROOT / "orb_slam2_ssd_semantic_tpu"
NO_LOOP = LoopConfig(enabled=False, enable_relocalization=False)


def test_import_leaves_jax_triton_and_reference_unloaded():
    code = (
        "import sys, pkgutil, importlib\n"
        "import orb_slam2_ssd_semantic_tpu_torch as p\n"
        "assert 'matplotlib' not in sys.modules, 'the package import loaded matplotlib'\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "new = {'ops.register', 'apps.live_rgbd', 'apps.web_viewer', 'viz', 'parallel.mesh',\n"
        "       'parallel.dist_ba', 'parallel.dist_bow', 'parallel.dist_occupancy'}\n"
        "assert new <= {n[len(p.__name__) + 1:] for n in names}, names\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'an import made a process group'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'triton', 'orb_slam2_ssd_semantic_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_never_import_jax_or_the_reference():
    bad = []
    for path in PKG.rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if (re.search(r"^\s*(import|from)\s+jax\b", line)
                    or re.search(r"orb_slam2_ssd_semantic_tpu\.", line)
                    or re.match(r"(import|from)\s+triton\b", line)):
                bad.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not bad, bad


def test_tracker_defaults_to_the_card():
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tracker(SlamConfig(loop=NO_LOOP))


def test_slam_system_and_detector_default_to_the_card():
    from orb_slam2_ssd_semantic_tpu_torch.config import SemanticConfig
    from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import BlockGridMap, empty_grid
    from orb_slam2_ssd_semantic_tpu_torch.semantic.consume import make_batched_consume
    from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detector
    from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import empty_db
    from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import init_ssdlite
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for make in (lambda: SlamSystem(SlamConfig(loop=NO_LOOP)),
                 lambda: SlamSystem(SlamConfig(loop=NO_LOOP), enable_semantics=True),
                 lambda: SlamSystem(SlamConfig(loop=NO_LOOP), enable_dense_map=True),
                 lambda: Detector(SemanticConfig(checkpoint_path=None)),
                 lambda: init_ssdlite(21), lambda: empty_db(4), lambda: empty_grid(),
                 lambda: BlockGridMap(),
                 lambda: make_batched_consume(SlamConfig(loop=NO_LOOP), [0], [0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_live_app_register_and_viewer_default_to_the_card(tmp_path):
    """Registration and undistortion of numpy images, the live app's `run`
    and `main` and the web viewer's `main` raise without a card unless
    given the CPU."""
    from orb_slam2_ssd_semantic_tpu_torch.apps import live_rgbd, web_viewer
    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
    from orb_slam2_ssd_semantic_tpu_torch.ops.register import (
        register_depth_to_color,
        undistort_image,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cam = CameraConfig(width=8, height=6, fx=5.0, fy=5.0, cx=4.0, cy=3.0)
    depth = np.full((6, 8), 2.0, np.float32)
    for call in (lambda: register_depth_to_color(depth, np.eye(4), cam, cam, 6, 8),
                 lambda: undistort_image(depth, cam),
                 lambda: live_rgbd.run(iter([]), SlamConfig(loop=NO_LOOP), out=str(tmp_path)),
                 lambda: live_rgbd.main(["--source", "synthetic", "--frames", "1",
                                         "--out", str(tmp_path)]),
                 lambda: web_viewer.main(["--frames", "1", "--port", "0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert torch.equal(register_depth_to_color(depth, np.eye(4), cam, cam, 6, 8, device="cpu"),
                       torch.from_numpy(depth))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("call", ["mesh"])
def test_slam_system_refuses_unported_parts(call):
    """Every part is ported; a `mesh` that is not a (kf, pt) DeviceMesh from
    `parallel/mesh.make_mesh` is refused, naming what it takes (the mesh
    paths themselves: `test_torch_mesh_engine.py`)."""
    from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    with pytest.raises(TypeError, match="DeviceMesh"):
        SlamSystem(SlamConfig(loop=NO_LOOP), device="cpu", **{call: object()})
    with pytest.raises(TypeError, match="DeviceMesh"):
        LoopCloser(SlamConfig(), device="cpu", **{call: object()})


def test_make_mesh_defaults_to_the_card_and_needs_a_group():
    """`make_mesh(device=None)` takes the card and raises without one; on
    the CPU, asked for, it needs the caller's process group: nothing
    falls back to gloo on its own."""
    import torch.distributed as dist

    from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1, device="cuda")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
    assert not dist.is_initialized()


def _tiny_config():
    """32x24 pixels, a 3-keypoint-per-level budget and a coarse dense map:
    each part below runs in well under a second on the CPU."""
    import dataclasses

    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, DenseMapConfig, OrbConfig

    return SlamConfig(loop=NO_LOOP,
                      camera=CameraConfig(fx=30.0, fy=30.0, cx=16.0, cy=12.0, width=32, height=24),
                      orb=OrbConfig(n_features=24, max_keypoints=32, n_levels=2, edge_threshold=4),
                      dense=dataclasses.replace(DenseMapConfig(), resolution=0.2,
                                                block_voxels=8, max_ray_steps=8))


@pytest.mark.parametrize("call", ["enable_dense_map", "track_stereo", "track_monocular",
                                  "save_map", "load_map", "save_octomap", "load_octomap"])
def test_slam_system_runs_each_part_on_the_cpu(call, tmp_path):
    """Each part refused before its slice now runs on the CPU when asked
    (the parity with JAX is `test_torch_dense.py`, `test_torch_stereo_mono.py`
    and `test_torch_system.py`)."""
    from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import BlockGridMap
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    cfg = _tiny_config()
    h, w = cfg.camera.height, cfg.camera.width
    img = np.random.default_rng(0).uniform(0, 255, (h, w)).astype(np.float32)
    depth = np.full((h, w), 2.0, np.float32)
    sys_ = SlamSystem(cfg, enable_dense_map=call in ("enable_dense_map", "save_octomap",
                                                     "load_octomap"), device="cpu")
    path = str(tmp_path / "x.npz")
    if call in ("enable_dense_map", "save_octomap", "load_octomap"):
        sys_.track_rgbd(img, depth, 0.0)
        assert isinstance(sys_.grid, BlockGridMap) and sys_.grid.blocks
        if call != "enable_dense_map":
            sys_.save_octomap(path)
            sys_.load_octomap(path)
            assert isinstance(sys_.grid, BlockGridMap) and sys_.grid.blocks
    elif call == "track_stereo":
        T = sys_.track_stereo(img, np.roll(img, -2, axis=1), 0.0)
        assert T.shape == (4, 4) and sys_.tracker.initialized
    elif call == "track_monocular":
        T = sys_.track_monocular(img, 0.0)
        assert np.array_equal(T, np.eye(4)) and sys_._mono_seed is not None
    else:
        sys_.track_rgbd(img, depth, 0.0)
        sys_.save_map(path)
        if call == "load_map":
            other = SlamSystem(cfg, device="cpu")
            other.load_map(path)
            assert other.tracker.initialized
            assert other.tracker._n_kfs == sys_.tracker._n_kfs == 1
        else:
            assert int(np.load(path)["n_kfs"]) == 1


def test_scan_entries_default_to_the_card():
    import numpy as np

    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
    from orb_slam2_ssd_semantic_tpu_torch.io.device_render import render_frames
    from orb_slam2_ssd_semantic_tpu_torch.tracking.scan_tracker import track_sequence
    from orb_slam2_ssd_semantic_tpu_torch.tracking.segmented import track_sequence_segmented

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    g, d = np.zeros((3, 8, 8), np.uint8), np.zeros((3, 8, 8), np.uint16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        track_sequence(g, d, SlamConfig(loop=NO_LOOP))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        track_sequence_segmented(g, d, SlamConfig(loop=NO_LOOP), segment_len=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_frames(np.eye(4, dtype=np.float32)[None], CameraConfig(width=8, height=8))


def _small_frames(n=3, h=120, w=160):
    """n copies of one smooth random texture (a still camera) and a flat
    depth of 2 m, as uint8 and uint16 mm."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    tex = gaussian_filter(np.random.default_rng(0).random((h, w)), 1.5)
    tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255.0
    return (np.repeat(tex.astype(np.uint8)[None], n, 0),
            np.full((n, h, w), 2000, np.uint16))


def _small_config(**dynamic):
    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OrbConfig

    return SlamConfig(loop=NO_LOOP, dynamic=DynamicConfig(**dynamic),
                      camera=CameraConfig(fx=134.0, fy=134.0, cx=80.0, cy=60.0, width=160,
                                          height=120),
                      orb=OrbConfig(n_features=100, max_keypoints=128))


@pytest.mark.parametrize("mask", ["use_flow", "use_geom"])
def test_scan_entries_accept_masks(mask):
    """The scan and the segmented runner take `use_flow` and `use_geom`."""
    from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state
    from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker
    from orb_slam2_ssd_semantic_tpu_torch.tracking.segmented import track_sequence_segmented

    cfg = _small_config()
    g, d = _small_frames()
    res = track_sequence_segmented(g, d, cfg, segment_len=1, device="cpu", **{mask: True})
    assert res.T_all.shape == (3, 4, 4) and np.isfinite(res.T_all).all()
    gt, dt = torch.from_numpy(g), torch.from_numpy(d)
    c0 = scan_tracker.init_scan(empty_state(cfg, torch.device("cpu")), gt[0], dt[0], cfg,
                                use_geom=mask == "use_geom")
    assert (c0.geom_db is not None) == (mask == "use_geom")
    _, T, stats = scan_tracker.track_sequence_scan(c0, gt[1:], dt[1:], cfg, **{mask: True})
    assert T.shape == (2, 4, 4) and stats.shape == (2, 4)


@pytest.mark.parametrize("cfg", [
    SlamConfig(loop=NO_LOOP, dynamic=DynamicConfig(enable_flow=True)),
    SlamConfig(loop=NO_LOOP, dynamic=DynamicConfig(enable_geometry=True)),
], ids=["flow", "geometry"])
def test_tracker_accepts_masks(cfg):
    """The Tracker takes each `dynamic.enable_*` and runs the mask's stage
    from the second frame on."""
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    small = _small_config(enable_flow=cfg.dynamic.enable_flow,
                          enable_geometry=cfg.dynamic.enable_geometry)
    tr = Tracker(small, device="cpu")
    assert tr.prev_gray is None
    assert (tr.geom_db is not None) == cfg.dynamic.enable_geometry
    g, d = _small_frames()
    for i in range(3):
        tr.process(g[i], d[i], float(i))
    stage = "mask.flow" if cfg.dynamic.enable_flow else "mask.geometry"
    assert tr.metrics.stages[stage].count == 2


@pytest.mark.parametrize("cfg", [
    SlamConfig(),
    SlamConfig(loop=LoopConfig(enabled=True, enable_relocalization=False)),
], ids=["loop", "loop_without_reloc"])
def test_tracker_accepts_loop_closing(cfg):
    """The default LoopConfig, and loop closing without relocalization,
    both build a LoopCloser on the tracker's device."""
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    tr = Tracker(cfg, device="cpu")
    assert tr.loop_closer is not None and tr.loop_closer.device.type == "cpu"
    assert tr.cfg.loop.enabled and tr.n_loops_closed == 0


def test_tracker_accepts_relocalization_without_loop_closing():
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    tr = Tracker(SlamConfig(loop=LoopConfig(enabled=False, enable_relocalization=True)),
                 device="cpu")
    assert tr.loop_closer is not None and tr.loop_closer.device.type == "cpu"
    assert Tracker(SlamConfig(loop=NO_LOOP), device="cpu").loop_closer is None


def test_precision_scope_disables_and_restores_tf32():
    from orb_slam2_ssd_semantic_tpu_torch.utils import precision

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with precision.highest_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_precision_scope_runs_deterministic_kernels_and_restores():
    """Inside the scope every op must be deterministic (raise, not warn,
    where it cannot be) and nothing fills fresh memory; the caller's
    settings come back on exit. The entry points carry the scope."""
    import torch.utils.deterministic as det

    from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
    from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker, segmented
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker
    from orb_slam2_ssd_semantic_tpu_torch.utils import precision

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(), det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(False)
    det.fill_uninitialized_memory = True
    try:
        with precision.highest_precision():
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
            assert not det.fill_uninitialized_memory
        assert not torch.are_deterministic_algorithms_enabled()
        assert det.fill_uninitialized_memory
        torch.use_deterministic_algorithms(True, warn_only=True)
        with precision.highest_precision():
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        det.fill_uninitialized_memory = saved[2]
    for fn in (Tracker.process, scan_tracker.track_sequence_scan, scan_tracker.track_sequence,
               segmented.track_sequence_segmented, LoopCloser.on_keyframe):
        assert getattr(fn, "__wrapped__", None) is not None, fn.__qualname__


def test_kernel_wrappers_take_the_plain_version_only_on_cpu():
    """CPU tensors go to the plain version and leave the launch counters
    alone; another device type is refused."""
    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_match, cuda_solve

    n0, m0 = cuda_solve.spd_solve.launches, cuda_match.window_match.launches
    x = cuda_solve.spd_solve(torch.eye(6) * 2.0, torch.ones(6))
    torch.testing.assert_close(x, torch.full((6,), 0.5))
    q = torch.zeros((256, 8), dtype=torch.int32)
    t = torch.zeros((128, 8), dtype=torch.int32)
    best, *_ = cuda_match.window_match(q, t, torch.zeros((256, 2)), torch.zeros((128, 2)), 1.0,
                                       torch.ones(256, dtype=torch.bool),
                                       torch.ones(128, dtype=torch.bool))
    assert (best == 0).all()
    assert (cuda_solve.spd_solve.launches, cuda_match.window_match.launches) == (n0, m0)
    with pytest.raises(ValueError):
        cuda_solve.spd_solve(torch.eye(6, device="meta"), torch.ones(6, device="meta"))


def test_launch_signatures_match_the_cuda_sources():
    """The ctypes argument types set at load agree with each kernel's C
    launch function in its source: a mismatch would pass pointers as ints
    (or the reverse) only on the card."""
    import ctypes
    import re

    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build

    for name, argtypes in cuda_build.SIGNATURES.items():
        src = (cuda_build.CSRC / f"{name}.cu").read_text()
        m = re.search(rf"^int {name}\(([^)]*)\)", src, re.MULTILINE)
        assert m, f"no `int {name}(...)` in {name}.cu"
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert all(p.startswith(("int ", "const void*", "void*")) for p in params), params
        assert argtypes == want, (name, params)


# Names of the JAX package that the port renamed or replaced, by (module,
# name), with the counterpart that stands in for each: (module, name).
RENAMED = {
    ("ops.image", "resize_bilinear"): ("ops.image", "resize_linear"),
    ("parallel.mesh", "kf_sharding"): ("parallel.mesh", "shard_rows"),
    ("parallel.mesh", "pt_sharding"): ("parallel.mesh", "shard_rows"),
    ("parallel.mesh", "replicated"): ("parallel.mesh", "replicate"),
    # The Pallas kernels' modules became the CUDA kernels' wrappers; their
    # `use_pallas` switch is each wrapper's dispatch on its tensors' device.
    ("ops.pallas_match", "fused_window_match"): ("ops.cuda_match", "window_match"),
    ("ops.pallas_match", "BIG"): ("ops.cuda_match", "BIG"),
    ("ops.pallas_match", "use_pallas"): ("ops.cuda_match", "window_match"),
    ("ops.pallas_solve", "spd_solve"): ("ops.cuda_solve", "spd_solve"),
    ("ops.pallas_solve", "PAD"): ("ops.cuda_solve", "PAD"),
    ("ops.pallas_solve", "use_pallas"): ("ops.cuda_solve", "spd_solve"),
}


def _public_names(path: pathlib.Path) -> list:
    """Public top-level functions, classes and assigned names of a module,
    read with `ast` (the JAX package is never imported here)."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                names += [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]
    return [n for n in names if not n.startswith("_")]


def test_port_has_every_public_name_of_the_jax_package():
    """Every public top-level function, class and constant of every module
    of the JAX package exists under the same name at the same path in the
    port, or is in RENAMED and its counterpart exists; every entry of
    RENAMED names something the JAX package has and the port lacks."""
    missing, used = [], set()
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = path.relative_to(JAX_PKG).with_suffix("").parts
        mod = ".".join(parts[:-1] if parts[-1] == "__init__" else parts)
        port_name = f"{PKG.name}.{mod}" if mod else PKG.name
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            port = None
        for name in _public_names(path):
            if port is not None and hasattr(port, name):
                continue
            if (mod, name) not in RENAMED:
                missing.append(f"{mod}.{name}")
                continue
            used.add((mod, name))
            other_mod, other = RENAMED[(mod, name)]
            counterpart = importlib.import_module(f"{PKG.name}.{other_mod}")
            assert hasattr(counterpart, other), (mod, name, other_mod, other)
    assert not missing, missing
    assert used == set(RENAMED), set(RENAMED) - used
