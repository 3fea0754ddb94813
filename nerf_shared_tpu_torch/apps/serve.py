"""HTTP render service over a checkpoint, on the port's render engine.

Counterpart of ``nerf_shared_tpu/apps/serve.py``: one ``EvalEngine``
(apps/train.build_eval_engine) kept alive behind a thread-safe HTTP
surface, rendering on ``--device`` (default ``cuda``).

Endpoints:
  GET  /health              -> {"status": "ok", "step": N}
  GET  /info                -> scene + engine metadata (JSON)
  GET  /render?theta=T&phi=P&radius=R[&fmt=png|npy]
                            -> novel view from a spherical orbit pose
                               (data/poses.pose_spherical, degrees)
  POST /render              -> {"c2w": [[...] x 3 or 4], "fmt": "png"}
                               novel view from an explicit camera-to-world
  GET  /metrics             -> Prometheus text (frames served, latency
                               quantiles, uptime)

A lock serializes /render (one frame on the card at a time) while /health
and /metrics stay responsive on the other server threads. PNG responses go
through the package's own encoder (data/images.png_encode).

Under torchrun with ``--mesh_shape N`` the engine splits each frame over
the N ranks (apps/train.build_eval_engine). Rank 0 runs the HTTP service;
the other ranks run ``RenderService.follow``: for each frame rank 0
broadcasts a fixed-size message (an opcode and the 3x4 c2w; the eval
render draws nothing, so no seed) and every rank renders it; a stop
message, sent when the server shuts down, ends the followers. The JAX service renders through a mesh-sharded engine
in its one process; one process a card needs the follower loop.

Usage:
  python -m nerf_shared_tpu_torch.apps.serve --config configs/lego.txt \
      [--port 8080] [--device cuda]
  torchrun --nproc_per_node 2 -m nerf_shared_tpu_torch.apps.serve \
      --config configs/lego.txt --mesh_shape 2
  # through a fast engine (/info's "engine"): the occupancy grid with
  # froxels, or --render_guided 48, or --render_gate 1e-3
  python -m nerf_shared_tpu_torch.apps.serve --config configs/lego.txt \
      --occ_grid 128 --occ_keep 32 --occ_fine 16
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.data.images import png_encode
from nerf_shared_tpu_torch.data.poses import pose_spherical
from nerf_shared_tpu_torch.utils.metrics import to8b


def serve_parser():
    parser = config_parser()
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="bind address for the render service")
    parser.add_argument("--port", type=int, default=8080,
                        help="TCP port (0 = pick a free one)")
    parser.add_argument("--serve_warmup", action="store_true",
                        help="render one warmup frame at startup (builds the "
                             "CUDA kernels before the first request)")
    return parser


def _encode_png(rgb_float) -> bytes:
    return png_encode(to8b(rgb_float))


def _encode_npy(rgb_float) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(rgb_float, np.float32))
    return buf.getvalue()


# the frame message rank 0 broadcasts to the followers: opcode, c2w (12)
_OP_STOP, _OP_RENDER = 0.0, 1.0
_MSG_LEN = 13


class RenderService:
    """The state behind the HTTP surface: one EvalEngine + serving stats
    (and, in a world of several ranks, the frame messages to the
    followers)."""

    def __init__(self, args, engine=None):
        if engine is None:
            from nerf_shared_tpu_torch.apps.train import build_eval_engine

            engine = build_eval_engine(args)
        self.engine = engine
        self.args = args
        self._lock = threading.Lock()
        self._frames = 0
        self._latencies = []
        self._started = time.time()
        self._stopped = False

    @property
    def _followers(self) -> bool:
        return self.engine.world.size > 1

    def _message(self, op: float, c2w=None) -> torch.Tensor:
        """Broadcast rank 0's frame message; every rank returns it."""
        msg = torch.zeros(_MSG_LEN, dtype=torch.float64, device=self.engine.world.device)
        if self.engine.world.is_main:
            msg[0] = op
            if c2w is not None:
                msg[1:13] = torch.as_tensor(np.asarray(c2w, np.float64).reshape(12))
        torch.distributed.broadcast(msg, src=0)
        return msg.cpu()

    def follow(self) -> int:
        """A rank > 0's loop: render each frame rank 0 announces, until the
        stop message. Returns the frames rendered."""
        n = 0
        while True:
            msg = self._message(_OP_STOP)
            if msg[0].item() == _OP_STOP:
                return n
            c2w = msg[1:13].numpy().astype(np.float32).reshape(3, 4)
            self.engine.render_poses(c2w[None])
            n += 1

    def close(self):
        """Stop the followers (rank 0, once) and leave the engine's world."""
        if self._followers and self.engine.world.is_main and not self._stopped:
            with self._lock:
                self._message(_OP_STOP)
                self._stopped = True
        self.engine.close()

    def render_c2w(self, c2w) -> np.ndarray:
        c2w = np.asarray(c2w, np.float32)
        if c2w.shape == (4, 4):
            c2w = c2w[:3]
        if c2w.shape != (3, 4):
            raise ValueError(f"c2w must be 3x4 or 4x4, got {c2w.shape}")
        with self._lock:
            if self._stopped:
                raise RuntimeError("the service is shutting down")
            t0 = time.perf_counter()
            if self._followers:
                self._message(_OP_RENDER, c2w)
            # the host copy of the frame fences the timing
            rgb = self.engine.render_poses(c2w[None])[0]
            dt = time.perf_counter() - t0
            self._frames += 1
            self._latencies.append(dt)
            if len(self._latencies) > 4096:
                self._latencies = self._latencies[-2048:]
        return rgb

    def render_spherical(self, theta, phi, radius) -> np.ndarray:
        return self.render_c2w(pose_spherical(theta, phi, radius)[:3, :4])

    def info(self) -> dict:
        eng = self.engine
        dev = torch.device(eng.device)
        return {
            "expname": self.args.expname,
            "dataset_type": self.args.dataset_type,
            "model_type": getattr(self.args, "model_type", "nerf"),
            "checkpoint_step": int(eng.start),
            "engine": eng.engine_name,
            "height": int(eng.H),
            "width": int(eng.W),
            "occ_fine": int(getattr(self.args, "occ_fine", 0)),
            "ema": float(getattr(self.args, "ema_decay", 0.0)) > 0.0,
            "device": str(dev),
            "n_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
            "world_size": int(eng.world.size),
        }

    def metrics_text(self) -> str:
        lat = sorted(self._latencies)

        def q(p):
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        lines = [
            "# TYPE nerf_render_frames_total counter",
            f"nerf_render_frames_total {self._frames}",
            "# TYPE nerf_render_latency_seconds summary",
            f'nerf_render_latency_seconds{{quantile="0.5"}} {q(0.5):.4f}',
            f'nerf_render_latency_seconds{{quantile="0.9"}} {q(0.9):.4f}',
            f'nerf_render_latency_seconds{{quantile="0.99"}} {q(0.99):.4f}',
            "# TYPE nerf_serve_uptime_seconds gauge",
            f"nerf_serve_uptime_seconds {time.time() - self._started:.1f}",
        ]
        return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    service: RenderService = None  # set by make_server

    def log_message(self, fmt, *a):  # quiet: the CLI prints its own lines
        pass

    def _send(self, code, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code, obj):
        self._send(code, json.dumps(obj).encode())

    def _send_frame(self, rgb, fmt):
        if fmt == "npy":
            self._send(200, _encode_npy(rgb), "application/octet-stream")
        else:
            self._send(200, _encode_png(rgb), "image/png")

    def do_GET(self):
        url = urlparse(self.path)
        try:
            if url.path == "/health":
                self._send_json(200, {
                    "status": "ok",
                    "step": self.service.info()["checkpoint_step"],
                })
            elif url.path == "/info":
                self._send_json(200, self.service.info())
            elif url.path == "/metrics":
                self._send(200, self.service.metrics_text().encode(),
                           "text/plain; version=0.0.4")
            elif url.path == "/render":
                qs = parse_qs(url.query)

                def f(name, default):
                    return float(qs.get(name, [default])[0])

                rgb = self.service.render_spherical(
                    f("theta", 0.0), f("phi", -30.0), f("radius", 4.0))
                self._send_frame(rgb, qs.get("fmt", ["png"])[0])
            else:
                self._send_json(404, {"error": f"no route {url.path}"})
        except Exception as e:  # surface errors as JSON, keep serving
            self._send_json(500, {"error": str(e)})

    def do_POST(self):
        url = urlparse(self.path)
        try:
            if url.path != "/render":
                self._send_json(404, {"error": f"no route {url.path}"})
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if "c2w" not in req:
                self._send_json(400, {"error": "missing 'c2w'"})
                return
            rgb = self.service.render_c2w(np.asarray(req["c2w"], np.float32))
            self._send_frame(rgb, req.get("fmt", "png"))
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
        except Exception as e:
            self._send_json(500, {"error": str(e)})


def make_server(service: RenderService, host="127.0.0.1", port=0):
    """A ThreadingHTTPServer wired to ``service``; the caller owns
    serve_forever/shutdown."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    args = serve_parser().parse_args(argv)
    service = RenderService(args)
    if not service.engine.world.is_main:
        try:
            n = service.follow()
        finally:
            service.close()
        print(f"rank {service.engine.world.rank}: rendered {n} frames; stopped")
        return
    info = service.info()
    print(f"serving {info['expname']} (step {info['checkpoint_step']}, "
          f"{info['engine']} engine, {info['width']}x{info['height']}, "
          f"{info['device']})")
    if args.serve_warmup:
        t0 = time.perf_counter()
        service.render_spherical(0.0, -30.0, 4.0)
        print(f"warmup frame in {time.perf_counter() - t0:.2f}s "
              "(kernel build included)")
    server = make_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"listening on http://{host}:{port}  "
          "(/health /info /render /metrics)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        service.close()


if __name__ == "__main__":
    main()
