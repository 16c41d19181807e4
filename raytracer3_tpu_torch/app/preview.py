"""MJPEG-over-HTTP live preview for the interactive viewer (port of
``raytracer3_tpu/app/preview.py``).

The reference presents every frame to a window through a swapchain
(src/renderer/vulkan/swapchain.rs:50-62,181-194); a render host has no
display, so the "swapchain" is a small in-process HTTP server on the
standard library:

- ``/``          minimal HTML page wrapping the stream
- ``/stream``    multipart/x-mixed-replace MJPEG, which any browser shows live
- ``/frame.jpg`` the latest frame

Frames are pulled on demand: ``publish`` copies the image to the host and
encodes it only when a client is connected and ``min_interval`` has passed,
so an unattended render never pays the device-to-host copy or the JPEG
encode. The encoder is PIL's, imported when a frame is published.
"""

from __future__ import annotations

import io
import threading
import time

import numpy as np
import torch

_BOUNDARY = b"rt3frame"

_INDEX_HTML = b"""<!doctype html>
<html><head><title>raytracer3_tpu_torch live</title>
<style>body{margin:0;background:#111;display:grid;place-items:center;height:100vh}
img{max-width:100vw;max-height:100vh;image-rendering:pixelated}</style></head>
<body><img src="/stream" alt="live render"></body></html>
"""


class PreviewServer:
    """Threaded MJPEG sink. ``start()`` then ``publish(img)`` per frame."""

    def __init__(
        self, port: int = 8787, quality: int = 85, min_interval: float = 0.2
    ):
        self.port = port
        self.quality = quality
        self.min_interval = min_interval
        self._cond = threading.Condition()
        self._jpeg: bytes | None = None
        self._seq = 0
        self._clients = 0
        self._last_pub = 0.0
        self._httpd = None
        self._thread = None

    # -- publishing --------------------------------------------------------

    def wants_frame(self) -> bool:
        """True when a client is connected and the rate limiter allows —
        callers skip the device pull entirely otherwise."""
        return (
            self._clients > 0
            and (time.perf_counter() - self._last_pub) >= self.min_interval
        )

    def publish(self, img) -> bool:
        """Encode [H,W,3] float (0..1) or uint8, a tensor on any device or an
        array, and wake streaming clients. Returns False (and does nothing,
        no copy to the host) when no client wants a frame."""
        if not self.wants_frame():
            return False
        from PIL import Image

        a = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
        if a.dtype != np.uint8:
            a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG", quality=self.quality)
        with self._cond:
            self._jpeg = buf.getvalue()
            self._seq += 1
            self._last_pub = time.perf_counter()
            self._cond.notify_all()
        return True

    # -- server ------------------------------------------------------------

    def start(self):
        """Serve on every interface from a daemon thread; port 0 takes a
        free port, written back to ``self.port``."""
        import http.server
        import socketserver

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_INDEX_HTML)))
                    self.end_headers()
                    self.wfile.write(_INDEX_HTML)
                elif self.path == "/frame.jpg":
                    with server._cond:
                        data = server._jpeg
                    if data is None:
                        self.send_response(503)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        f"multipart/x-mixed-replace; boundary={_BOUNDARY.decode()}",
                    )
                    self.end_headers()
                    server._clients += 1
                    last = -1
                    try:
                        while True:
                            with server._cond:
                                # Before the first publish there is nothing
                                # to send: wait for it, not for a change of
                                # the sequence number alone.
                                server._cond.wait_for(
                                    lambda: server._jpeg is not None and server._seq != last, timeout=5.0
                                )
                                if server._seq == last or server._jpeg is None:
                                    continue  # keepalive tick
                                data = server._jpeg
                                last = server._seq
                            self.wfile.write(
                                b"--" + _BOUNDARY + b"\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(data)}\r\n\r\n".encode()
                            )
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    finally:
                        server._clients -= 1
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        class Srv(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = Srv(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
