"""Live raw-vs-optimized 3-D view, the reference Pangolin viewer's analog.

Counterpart of `pose_estimation_tpu/live_viewer.py`, a copy (numpy,
threading and http.server; matplotlib imported when a frame is rendered).
The reference's `cfsd::Viewer` (`src/viewer.cpp:21-154`) runs an OpenGL
thread showing the IMU-predicted ("raw") and optimized trajectories, the
current pose and the landmark cloud, fed through window-indexed
thread-safe push calls (`pushRawPosition` `:202`, `pushPosition` `:220`,
`pushPose` `:240`, `pushLandmark` `:248`). Here a background thread redraws
a 3-D matplotlib scene at a fixed cadence into a PNG and, optionally,
serves it over HTTP (`http://localhost:<port>/`, an auto-refreshing page).
The push API and its window-indexed overwrite match the reference, so
`VisualInertialSLAM.set_viewer(...)` is the analog of
`VisualInertialSLAM::setViewer` (`visual-inertial-slam.hpp:43`).

All pushes are non-blocking and cheap (list/dict writes under a lock);
rendering happens on the viewer thread, off the pipeline's critical path.
"""

from __future__ import annotations

import io
import threading
import time

import numpy as np


class LiveViewer:
    """Background renderer with the reference Viewer's push surface.

    Parameters
    ----------
    out_path: PNG path rewritten every `interval` seconds (None disables).
    port: serve an auto-refreshing live page on localhost:port (None
        disables the HTTP server).
    interval: render cadence in seconds.
    window_size: W — raw/optimized positions are window-indexed and
        OVERWRITTEN in place like the reference's `_positions` vectors
        (`viewer.cpp:220-238`): index i < W updates slot i of the sliding
        window tail; on keyframe the tail extends.
    """

    def __init__(self, out_path: str | None = "live_view.png",
                 port: int | None = None, interval: float = 1.0,
                 window_size: int = 4, max_landmarks: int = 5000):
        self.out_path = out_path
        self.port = port
        self.interval = interval
        self.w = window_size
        self.max_landmarks = max_landmarks
        self._lock = threading.Lock()
        # committed history + live window tail (window-indexed overwrite)
        self._pos_hist: list[np.ndarray] = []
        self._pos_tail: dict[int, np.ndarray] = {}
        self._raw_hist: list[np.ndarray] = []
        self._raw_tail: dict[int, np.ndarray] = {}
        self._pose: tuple[np.ndarray, np.ndarray] | None = None
        self._landmarks: np.ndarray | None = None
        self._frame_count = 0
        self._png: bytes | None = None
        self._renders = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._server = None

    # ---- push API (mirrors viewer.cpp:202-260) ------------------------- #

    def push_raw_position(self, p, i: int):
        """IMU-predicted position of window slot i (`pushRawPosition`)."""
        with self._lock:
            self._raw_tail[int(i)] = np.asarray(p, np.float64).copy()

    def push_position(self, p, i: int):
        """Optimized position of window slot i (`pushPosition`)."""
        with self._lock:
            self._pos_tail[int(i)] = np.asarray(p, np.float64).copy()

    def push_keyframe(self):
        """Commit window slot 0 to history (the reference grows its
        vectors when the window slides)."""
        with self._lock:
            if 0 in self._pos_tail:
                self._pos_hist.append(self._pos_tail[0])
            if 0 in self._raw_tail:
                self._raw_hist.append(self._raw_tail[0])
            self._pos_tail = {i - 1: p for i, p in self._pos_tail.items() if i > 0}
            self._raw_tail = {i - 1: p for i, p in self._raw_tail.items() if i > 0}

    def push_pose(self, R, p):
        """Current body pose (frustum; `pushPose` :240)."""
        with self._lock:
            self._pose = (np.asarray(R, np.float64).copy(),
                          np.asarray(p, np.float64).copy())

    def push_landmark(self, points, valid=None):
        """Landmark cloud snapshot (`pushLandmark` :248)."""
        pts = np.asarray(points, np.float64)
        if valid is not None:
            pts = pts[np.asarray(valid, bool)]
        with self._lock:
            self._landmarks = pts[: self.max_landmarks].copy()
            self._frame_count += 1

    # ---- lifecycle ------------------------------------------------------ #

    def start(self):
        if self.port is not None:
            self._start_server()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self._server is not None:
            self._server.shutdown()
            self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- rendering ------------------------------------------------------ #

    def _snapshot(self):
        with self._lock:
            pos = self._pos_hist + [
                self._pos_tail[i] for i in sorted(self._pos_tail)
            ]
            raw = self._raw_hist + [
                self._raw_tail[i] for i in sorted(self._raw_tail)
            ]
            return (
                np.array(pos) if pos else np.zeros((0, 3)),
                np.array(raw) if raw else np.zeros((0, 3)),
                self._pose,
                None if self._landmarks is None else self._landmarks.copy(),
                self._frame_count,
            )

    def render_once(self) -> bytes:
        """Render the current scene to PNG bytes (also called by the
        thread; public so tests and notebook users can render on demand)."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        pos, raw, pose, lms, n = self._snapshot()
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        if raw.size:
            ax.plot(raw[:, 0], raw[:, 1], raw[:, 2],
                    color="#888888", lw=1.0, label="raw (IMU-predicted)")
        if pos.size:
            ax.plot(pos[:, 0], pos[:, 1], pos[:, 2],
                    color="#1f77b4", lw=1.6, label="optimized")
        if lms is not None and lms.size:
            ax.scatter(lms[:, 0], lms[:, 1], lms[:, 2],
                       s=2, c="#2ca02c", alpha=0.4, label="landmarks")
        if pose is not None:
            R, p = pose
            # camera frustum stub: the 3 body axes (viewer.cpp:156-190)
            colors = ("r", "g", "b")
            for a in range(3):
                tip = p + 0.3 * R[:, a]
                ax.plot([p[0], tip[0]], [p[1], tip[1]], [p[2], tip[2]],
                        color=colors[a], lw=2)
        ax.set_title(f"pose_estimation_tpu_torch live view — frame {n}")
        if pos.size or raw.size or lms is not None:
            ax.legend(loc="upper left", fontsize=8)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=90)
        plt.close(fig)
        png = buf.getvalue()
        with self._lock:
            self._png = png
            self._renders += 1
        if self.out_path:
            tmp = str(self.out_path) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(png)
            import os
            os.replace(tmp, self.out_path)
        return png

    def _run(self):
        while not self._stop.is_set():
            try:
                self.render_once()
            except Exception:       # rendering must never kill ingestion
                pass
            self._stop.wait(self.interval)

    # ---- HTTP live page -------------------------------------------------- #

    def _start_server(self):
        import http.server

        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence per-request stderr spam
                pass

            def do_GET(self):
                if self.path.startswith("/view.png"):
                    with viewer._lock:
                        png = viewer._png
                    if png is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    body = (
                        "<html><head><title>pose_estimation_tpu_torch live"
                        "</title></head><body style='background:#111'>"
                        f"<img src='/view.png' id='v' style='width:100%'>"
                        "<script>setInterval(()=>{document.getElementById"
                        "('v').src='/view.png?t='+Date.now()}, "
                        f"{int(self.server.viewer.interval * 1000)})"
                        "</script></body></html>"
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler
        )
        self._server.viewer = self
        self.port = self._server.server_address[1]   # resolve port 0
        threading.Thread(
            target=self._server.serve_forever, daemon=True
        ).start()
