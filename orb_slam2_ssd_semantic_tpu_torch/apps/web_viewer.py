"""Live web viewer: the engine's interactive observability surface
(counterpart of the JAX package's `apps/web_viewer.py`).

The reference's Viewer/FrameDrawer (perfect/src/Viewer.cc,
FrameDrawer.cc) open Pangolin/OpenCV windows, which a headless host
cannot show. Here a small stdlib HTTP server streams the tracker's live
state as a self-refreshing dashboard: the current frame with its
keypoint/status overlay (FrameDrawer::DrawFrame + DrawTextInfo), the
top-down map view with keyframes (MapDrawer sparse view), and the
per-stage timing table (utils.metrics). Attach it to a running
SlamSystem or Tracker in the same process:

    from orb_slam2_ssd_semantic_tpu_torch.apps.web_viewer import LiveViewer
    viewer = LiveViewer(system, port=8600)
    viewer.start()            # serves http://localhost:8600/
    ...
    viewer.publish_frame(gray)   # call per frame or per keyframe
    viewer.stop()

The images are drawn with matplotlib (imported when first drawn; only
the viewers need it). Standalone demo on the synthetic world (on the
card unless given `--device cpu`):

    python -m orb_slam2_ssd_semantic_tpu_torch.apps.web_viewer --frames 120
"""

from __future__ import annotations

import io
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html><html><head><title>tpu-semantic-slam</title>
<style>
body {background:#111;color:#ddd;font-family:monospace;margin:16px}
img {border:1px solid #444;margin:4px;image-rendering:pixelated}
pre {color:#9c9}
</style></head><body>
<h3>tpu-semantic-slam live viewer</h3>
<div>
<img src="/frame.png" id="f" width="640">
<img src="/map.png" id="m" width="420">
</div>
<pre id="s"></pre>
<script>
setInterval(()=>{
  document.getElementById('f').src='/frame.png?'+Date.now();
  document.getElementById('m').src='/map.png?'+Date.now();
  fetch('/stats').then(r=>r.text()).then(t=>document.getElementById('s').textContent=t);
}, 500);
</script></body></html>"""


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _png(fig, plt) -> bytes:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", facecolor="#111", bbox_inches="tight", pad_inches=0.05)
    plt.close(fig)
    return buf.getvalue()


class LiveViewer:
    """Threaded HTTP dashboard over a running tracker (a `Tracker`, or a
    `SlamSystem` whose `.tracker` it reads)."""

    def __init__(self, system_or_tracker, port: int = 8600):
        self._obj = system_or_tracker
        self.port = port
        self._frame_png: bytes | None = None
        self._map_png: bytes | None = None
        self._lock = threading.Lock()
        self._last_map = 0.0
        self._server = None

    @property
    def tracker(self):
        return getattr(self._obj, "tracker", self._obj)

    # ---- publishing -------------------------------------------------------

    def publish_frame(self, gray, T_cw=None) -> None:
        """Render the current-frame overlay (keypoints, matched in green,
        and the state line) into a PNG; refresh the map view at most every
        2 s."""
        import numpy as np

        plt = _pyplot()
        tr = self.tracker
        fig, ax = plt.subplots(figsize=(6.4, 4.8), dpi=100)
        ax.imshow(np.asarray(gray), cmap="gray", vmin=0, vmax=255)
        if tr.last_frame is not None:
            uv = tr.last_frame.feats.uv.cpu().numpy()
            ok = tr.last_frame.feats.valid.cpu().numpy()
            matched = tr.last_kp_point.cpu().numpy() >= 0
            ax.plot(uv[ok & ~matched, 0], uv[ok & ~matched, 1], ".", ms=2, color="#66f")
            ax.plot(uv[ok & matched, 0], uv[ok & matched, 1], ".", ms=2.5, color="#3f6")
        s = tr.stats[-1] if tr.stats else {}
        ax.set_title(
            f"{tr.status}  kfs={s.get('kfs', 0)} pts={s.get('points', 0)} "
            f"inl={s.get('inliers', 0)} loops={tr.n_loops_closed}",
            fontsize=9, color="w",
        )
        ax.set_axis_off()
        fig.patch.set_facecolor("#111")
        png = _png(fig, plt)
        with self._lock:
            self._frame_png = png
        if time.time() - self._last_map > 2.0:
            self._last_map = time.time()
            self._publish_map()

    def _publish_map(self) -> None:
        from orb_slam2_ssd_semantic_tpu_torch.viz import keyframe_centres

        plt = _pyplot()
        st = self.tracker.state
        fig, ax = plt.subplots(figsize=(4.6, 4.6), dpi=100)
        pos = st.points.pos[st.points.valid].cpu().numpy()
        if len(pos):
            ax.scatter(pos[:, 0], pos[:, 2], s=0.4, c="#888", alpha=0.5)
        c = keyframe_centres(st)
        if len(c):
            ax.plot(c[:, 0], c[:, 2], ".-", ms=3, lw=0.8, color="#4af")
        ax.set_aspect("equal")
        ax.set_facecolor("#181818")
        fig.patch.set_facecolor("#111")
        ax.tick_params(colors="#777", labelsize=7)
        png = _png(fig, plt)
        with self._lock:
            self._map_png = png

    # ---- server -----------------------------------------------------------

    def start(self) -> None:
        """Serve on 127.0.0.1:`port` from a daemon thread (port 0 takes a
        free port; `port` then holds it)."""
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no request log
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Cache-Control", "no-store")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                with viewer._lock:
                    frame = viewer._frame_png
                    mp = viewer._map_png
                if path == "/":
                    self._send(_PAGE, "text/html")
                elif path == "/frame.png" and frame:
                    self._send(frame, "image/png")
                elif path == "/map.png" and mp:
                    self._send(mp, "image/png")
                elif path == "/stats":
                    self._send(viewer.tracker.metrics.report().encode(), "text/plain")
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer(("127.0.0.1", self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    dev = device_mod.resolve(args.device)
    seq = SyntheticSequence(n_frames=args.frames)
    tr = Tracker(SlamConfig(), device=dev)
    viewer = LiveViewer(tr, port=args.port)
    viewer.start()
    print(f"live viewer at http://localhost:{viewer.port}/")
    for i in range(len(seq)):
        g, d = seq.gray_depth(i)
        tr.process(g, d, float(seq.stamps[i]))
        viewer.publish_frame(g)
    print("sequence done; viewer stays up (ctrl-c to exit)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        viewer.stop()


if __name__ == "__main__":
    main()
