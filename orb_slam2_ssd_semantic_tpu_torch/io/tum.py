"""TUM RGB-D dataset IO: trajectory files, file-list association, image loading.

Host-side (numpy/PIL) — this is the data pipeline feeding the device; the
behavioral spec is the reference's tool/associate.py and the TUM-format
readers/writers in perfect/src/System.cc:454-541 (SaveTrajectoryTUM) and
Examples/RGB-D/rgbd_tum.cc:143-167 (LoadImages).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


# ---- trajectory files -----------------------------------------------------


def read_trajectory(path: str):
    """Read a TUM trajectory file: lines of `timestamp tx ty tz qx qy qz qw`.

    Returns (stamps (N,), t (N,3), q (N,4) in xyzw order)."""
    stamps, ts, qs = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) < 8:
                continue
            stamps.append(vals[0])
            ts.append(vals[1:4])
            qs.append(vals[4:8])
    return np.asarray(stamps), np.asarray(ts), np.asarray(qs)


def write_trajectory(path: str, stamps, translations, quaternions):
    """Write TUM format with the reference's precision (System.cc:497-500:
    timestamps at 6 decimals, pose at 9)."""
    with open(path, "w") as f:
        for s, t, q in zip(stamps, translations, quaternions):
            f.write(
                "%.6f %.9f %.9f %.9f %.9f %.9f %.9f %.9f\n"
                % (s, t[0], t[1], t[2], q[0], q[1], q[2], q[3])
            )


def write_trajectory_kitti(path: str, poses_wc):
    """KITTI format: 12 row-major values of the 3x4 camera-to-world matrix
    per line (System.cc:543-588)."""
    with open(path, "w") as f:
        for T in poses_wc:
            row = np.asarray(T)[:3, :4].reshape(-1)
            f.write(" ".join("%.9e" % v for v in row) + "\n")


# ---- association ----------------------------------------------------------


def associate(stamps_a, stamps_b, offset: float = 0.0, max_difference: float = 0.02):
    """Greedy best-first timestamp association (behavioral equivalent of
    tool/associate.py:83-111): sort all candidate pairs with
    |a - (b+offset)| < max_difference by difference, take each stamp at
    most once. Returns list of (index_a, index_b)."""
    stamps_a = np.asarray(stamps_a)
    stamps_b = np.asarray(stamps_b)
    diff = np.abs(stamps_a[:, None] - (stamps_b[None, :] + offset))
    ia, ib = np.nonzero(diff < max_difference)
    order = np.argsort(diff[ia, ib], kind="stable")
    used_a = np.zeros(len(stamps_a), dtype=bool)
    used_b = np.zeros(len(stamps_b), dtype=bool)
    matches = []
    for k in order:
        a, b = int(ia[k]), int(ib[k])
        if not used_a[a] and not used_b[b]:
            used_a[a] = used_b[b] = True
            matches.append((a, b))
    matches.sort()
    return matches


def read_file_list(path: str):
    """Read rgb.txt / depth.txt: `timestamp filename` lines."""
    stamps, names = [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            names.append(parts[1])
    return np.asarray(stamps), names


def load_association(path: str):
    """Read an associate.txt produced by tool/associate.py:
    `t_rgb rgb_file t_depth depth_file` per line."""
    stamps, rgb_files, depth_files = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            stamps.append(float(p[0]))
            rgb_files.append(p[1])
            depth_files.append(p[3])
    return np.asarray(stamps), rgb_files, depth_files


# ---- dataset --------------------------------------------------------------


@dataclass
class TumSequence:
    """Iterable TUM RGB-D sequence (equivalent of the rgbd_tum.cc driver's
    image loading; depth scaled by 1/DepthMapFactor as in Tracking.cc:676)."""

    root: str
    stamps: np.ndarray
    rgb_files: list
    depth_files: list
    depth_factor: float = 5000.0

    @classmethod
    def open(cls, root: str, association: str | None = None, depth_factor: float = 5000.0):
        if association is None:
            association = os.path.join(root, "associate.txt")
        if os.path.exists(association):
            stamps, rgb_files, depth_files = load_association(association)
        else:
            sa, na = read_file_list(os.path.join(root, "rgb.txt"))
            sb, nb = read_file_list(os.path.join(root, "depth.txt"))
            matches = associate(sa, sb)
            stamps = np.array([sa[a] for a, _ in matches])
            rgb_files = [na[a] for a, _ in matches]
            depth_files = [nb[b] for _, b in matches]
        return cls(root, stamps, rgb_files, depth_files, depth_factor)

    def __len__(self) -> int:
        return len(self.stamps)

    def __getitem__(self, i: int):
        """Returns (timestamp, rgb uint8 (H,W,3), depth float32 meters (H,W))."""
        from PIL import Image

        rgb = np.asarray(Image.open(os.path.join(self.root, self.rgb_files[i])).convert("RGB"))
        depth_raw = np.asarray(Image.open(os.path.join(self.root, self.depth_files[i])))
        depth = depth_raw.astype(np.float32) / self.depth_factor
        return float(self.stamps[i]), rgb, depth


def associate_main(argv=None):
    """CLI twin of `python associate.py rgb.txt depth.txt` (tool/associate.py)."""
    import argparse

    p = argparse.ArgumentParser(description="associate two TUM timestamp files")
    p.add_argument("first_file")
    p.add_argument("second_file")
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--max_difference", type=float, default=0.02)
    args = p.parse_args(argv)
    sa, na = read_file_list(args.first_file)
    sb, nb = read_file_list(args.second_file)
    for a, b in associate(sa, sb, args.offset, args.max_difference):
        print(f"{sa[a]:f} {na[a]} {sb[b] - args.offset:f} {nb[b]}")


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, matching cv::cvtColor(COLOR_RGB2GRAY) as used in
    Tracking::GrabImageRGBD (Tracking.cc:655-668). Returns float32 [0,255]."""
    rgb = rgb.astype(np.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


if __name__ == "__main__":
    associate_main()
