"""The port's copy of the native C++ TUM loader (`io/native_loader.py`):
the twin of `tests/test_native_loader.py` (build, decode parity against
PIL, the uint16 path, a missing association), and the same frames as the
JAX package's `NativeTumSequence` on the same directory.

The port builds `cpp/tum_loader.cpp` into `build/torch_native/`; the JAX
wrapper is run here on that library (the same source), so that this file
never writes the JAX package's `build/libtum_loader.so`, which
`tests/test_native_loader.py` may be building in another worker."""

import os

import numpy as np
import pytest
from PIL import Image

from orb_slam2_ssd_semantic_tpu_torch.io import native_loader as tnl
from orb_slam2_ssd_semantic_tpu_torch.io.tum import TumSequence
from _torch_threads import _few_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    """A tiny on-disk TUM sequence (PNG rgb + 16-bit depth)."""
    root = tmp_path_factory.mktemp("tum_seq_port")
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(6):
        t = 100.0 + i / 30.0
        rgb = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
        depth = rng.integers(500, 20000, (480, 640), dtype=np.uint16)
        Image.fromarray(rgb).save(root / "rgb" / f"{t:.6f}.png")
        Image.fromarray(depth).save(root / "depth" / f"{t:.6f}.png")
        lines.append(f"{t:.6f} rgb/{t:.6f}.png {t:.6f} depth/{t:.6f}.png")
    (root / "associate.txt").write_text("\n".join(lines) + "\n")
    return str(root)


def test_native_loader_builds_and_matches_pil(tum_dir):
    ref = TumSequence.open(tum_dir)
    native = tnl.NativeTumSequence(tum_dir, as_float=True)
    assert len(native) == len(ref) == 6
    assert os.path.dirname(tnl._build_library()).endswith(os.path.join("build", "torch_native"))
    for i, (stamp, rgb, depth) in enumerate(native):
        stamp_ref, rgb_ref, depth_ref = ref[i]
        assert abs(stamp - stamp_ref) < 1e-6
        np.testing.assert_array_equal(rgb, rgb_ref)
        np.testing.assert_allclose(depth, depth_ref, atol=1e-6)
    native.close()


def test_native_loader_uint16_path(tum_dir):
    native = tnl.NativeTumSequence(tum_dir, depth_factor=5000.0)
    _, _, d = next(native)
    assert d.dtype == np.uint16
    # 5000 units/m -> mm conversion: value/5.
    _, _, dref = TumSequence.open(tum_dir)[0]
    np.testing.assert_allclose(d.astype(np.float32) / 1000.0, dref, atol=2e-3)
    native.close()


def test_native_loader_missing_association(tum_dir):
    with pytest.raises(FileNotFoundError):
        tnl.NativeTumSequence(tum_dir, association="/nonexistent/assoc.txt")


@pytest.mark.parametrize("as_float", [False, True], ids=["uint16", "float"])
def test_native_loader_equals_the_jax_wrapper(tum_dir, as_float, monkeypatch):
    from orb_slam2_ssd_semantic_tpu.io import native_loader as jnl

    monkeypatch.setattr(jnl, "_build_library", tnl._build_library)
    monkeypatch.setattr(jnl, "_LIB", None)
    want = list(jnl.NativeTumSequence(tum_dir, as_float=as_float))
    got = list(tnl.NativeTumSequence(tum_dir, as_float=as_float))
    assert len(got) == len(want) == 6
    for (s, rgb, d), (sj, rgbj, dj) in zip(got, want):
        assert s == sj and d.dtype == dj.dtype
        np.testing.assert_array_equal(rgb, rgbj)
        np.testing.assert_array_equal(d, dj)
