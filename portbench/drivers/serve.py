"""Traffic kind ``serve``: closed-loop clients of the HTTP render service.

Set-up builds the engine as ``apps/train.py`` ``build_eval_engine(args,
ds=...)`` builds it (the dense engine: B3 and B5 on a card) over a seeded
dataset, puts the benchmark's weights into its networks, and serves it
through ``apps/serve.py`` ``make_server(RenderService(...))`` on
127.0.0.1, port 0, in this process. Each client ``POST``s ``/render``
with a pose and ``fmt: npy`` and waits for the float frame before its next
request; the poses walk the dataset's render path from a seeded start,
each jittered from the seed. The service renders one frame at a time under
its lock. Warm-up renders ``warmup_frames`` frames through the same route.

The check: once the window has closed and the engine is freed, the
reference renders a seeded sample of the frames the clients received, at
their poses, and the gaps of their pixels are compared: the widest, and
the 50th, 90th and 99th percentiles (the cell's limits file names the
ones it compares).
"""

from __future__ import annotations

import gc
import http.client
import io
import json
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.core import inputs, program
from portbench.core.trace import DeviceTrace, Spans
from portbench.reference import compare
from portbench.reference import nerf as ref

# rays whose last sample's density is within this of 0 are left out of
# the frame comparison: the 1e10 final interval turns their alpha from 0
# to 1 on any rounding of that density
FLIP_BAND = 1e-3


class Driver:
    kind = "serve"

    def __init__(self, cell, seed: int, device, faults=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.scene = inputs.scene_of(self.cfg)
        self.net = inputs.net_of(self.cfg)
        self.faults = faults or {}
        self.spans = Spans()
        self.host = {}
        self.frames: List[np.ndarray] = []
        self.sent: List[np.ndarray] = []
        self.k = 0

    # ---------------------------------------------------------- set-up
    def setup(self):
        from nerf_shared_tpu_torch.apps.serve import RenderService, make_server
        from nerf_shared_tpu_torch.apps.train import build_eval_engine
        from nerf_shared_tpu_torch.data.datasets import Dataset

        self.workdir = program.work_dir()
        args = program.parse_args(self.cfg, self.traffic, self.seed, self.device, self.workdir)
        self.args = args
        sc = self.scene
        poses, self.path, i_train, i_test = inputs.make_poses(self.seed, self.cfg)
        # the dense engine reads the geometry; no image reaches a render
        ds = Dataset(images=np.zeros((0, sc["H"], sc["W"], 3), np.float32), poses=poses,
                     render_poses=self.path, hwf=(sc["H"], sc["W"], sc["focal"]),
                     i_train=i_train, i_val=i_test, i_test=i_test,
                     K=np.asarray(sc["K"], np.float64), near=sc["near"], far=sc["far"])
        engine = build_eval_engine(args, ds=ds)
        self.weights = inputs.make_weights(self.seed, self.cfg, self.device)
        program.load_weights(engine.coarse, self.weights["coarse"])
        program.load_weights(engine.fine, self.weights["fine"])
        self.precision = engine.renderer.cfg.precision
        self.engine_name = engine.engine_name
        self._span_engine(engine)
        self.service = RenderService(args, engine=engine)
        if "setup" in self.faults:
            self.faults["setup"](self)
        self.server = make_server(self.service, "127.0.0.1", 0)
        self.addr = self.server.server_address[:2]
        self.thread = threading.Thread(target=self.server.serve_forever, name="render-service",
                                       kwargs={"poll_interval": 0.05})
        self.thread.start()
        for _ in range(self.traffic["warmup_frames"]):
            if self._request(self.next_pose()) is None:
                raise RuntimeError("the warm-up frame failed")

    def _span_engine(self, engine):
        """The benchmark's span around each frame the engine renders."""
        render = engine.render_poses
        spans = self.spans

        def timed(*a, **kw):
            s = time.perf_counter_ns()
            try:
                return render(*a, **kw)
            finally:
                spans.add("render_poses", s, time.perf_counter_ns())

        engine.render_poses = timed

    def next_pose(self) -> np.ndarray:
        c2w = inputs.request_pose(self.seed, self.path, self.k, self.traffic["jitter"])
        self.k += 1
        return c2w

    def _request(self, c2w: np.ndarray):
        """One POST /render; the float frame, or None when it failed."""
        body = json.dumps({"c2w": c2w.tolist(), "fmt": "npy"}).encode()
        conn = http.client.HTTPConnection(*self.addr, timeout=600)
        s = time.perf_counter_ns()
        try:
            conn.request("POST", "/render", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
        finally:
            conn.close()
        self.spans.add("request", s, time.perf_counter_ns())
        if resp.status != 200:
            return None
        return np.load(io.BytesIO(data))

    # ---------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> dict:
        dev = self.device
        tracer = DeviceTrace(dev) if trace else None
        before = program.counters()
        n_before = len(self.spans.named("request"))
        rendered_before = len(self.spans.named("render_poses"))
        attempted = failed = 0
        if tracer is not None:
            t0 = tracer.open()
        else:
            t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        t_last = t0
        while time.perf_counter_ns() < deadline:
            c2w = self.next_pose()
            attempted += 1
            frame = self._request(c2w)
            if frame is None or frame.shape != (self.scene["H"], self.scene["W"], 3):
                failed += 1
                continue
            t_last = time.perf_counter_ns()
            self.frames.append(frame)
            self.sent.append(c2w)
        win = tracer.close(t_last) if tracer is not None else None
        after = program.counters()
        window_s = (t_last - t0) / 1e9
        client = [(e - s) / 1e6 for s, e in self.spans.named("request")[n_before:]]
        render = [(e - s) / 1e6 for s, e in self.spans.named("render_poses")[rendered_before:]]
        self.host.update(client_ms=client, render_ms=render)
        n = len(self.frames)
        return {"t0": t0, "attempted": attempted, "failed": failed, "units": n, "window_s": window_s,
                "trace": win, "launches": {k: after[k] - before[k] for k in after},
                "metrics": {"frame_ms": 1e3 * window_s / n if n else float("nan")}}

    def span_labels(self) -> Dict[str, str]:
        return {"render_poses": "host in the engine (rays, sampling, launches, frame copy)",
                "request": "HTTP handler, npy encode and decode"}

    # ----------------------------------------------------------- check
    def release(self):
        """Stop the service and free the engine before the reference runs."""
        self._stop()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "check"))
        n = len(self.frames)
        picks = sorted(rng.choice(n, size=min(n, self.traffic["checked_frames"]),
                                  replace=False).tolist()) if n else []
        ref.no_tf32()
        worst = {k: 0.0 for k in ("max", "p50", "p90", "p99", "left_out")} if picks else \
            {k: float("nan") for k in ("max", "p50", "p90", "p99", "left_out")}
        for i in picks:
            out = self.reference(self.sent[i])
            gaps = compare.frame_gaps(torch.as_tensor(self.frames[i]), out["rgb"],
                                      out["sigma_last"], FLIP_BAND)
            worst = {k: compare.worst(worst[k], v) for k, v in gaps.items()}
        self.detail = {"frames_checked": picks, "rays_left_out": worst.pop("left_out")}
        return {"frame_gap": worst["max"], **{f"frame_{k}": v for k, v in worst.items()
                                              if k != "max"}}

    def reference(self, c2w: np.ndarray) -> dict:
        """The reference's frame at pose ``c2w``."""
        return ref.render_frame(self.weights["coarse"], self.weights["fine"], self.net,
                                self.scene, torch.as_tensor(c2w, device=self.device))

    def _stop(self):
        if getattr(self, "server", None) is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=60)
            self.server = None
        if getattr(self, "service", None) is not None:
            self.service.close()
            self.service = None

    def close(self):
        import shutil

        self._stop()
        if hasattr(self, "workdir"):
            shutil.rmtree(self.workdir, ignore_errors=True)
