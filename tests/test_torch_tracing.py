"""The port's spans and host-sync counter (utils/profiling.py) on the CPU.

- Without a profiler nothing is recorded and no ``record_function`` opens.
- Under ``torch.profiler.profile`` spans nest, name their parents and
  share their unit ids; two threads keep their own stacks; the bound
  drops spans and counts them; a planted sync warning is counted against
  the innermost span of its own thread every time it is raised, and is
  swallowed; one from a thread with no open span is not counted.
- One CPU ``train_step`` records ``train_step`` and its four phases; one
  ``POST /render`` through ``make_server`` records the request, the
  engine's frame and copy, and the encode, under one id; ``/metrics``
  carries the lock-wait summary.
"""

import json
import threading
import time
import urllib.request
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_shared_tpu_torch.utils import profiling


def _record():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(rec):
    return {s.name: (i, s) for i, s in enumerate(rec.spans)}


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    rec = profiling.Recorder()
    with rec.span("a", 3):
        with rec.span("b"):
            pass
    assert rec.span("a") is rec.span("b") is profiling.span("c")
    assert rec.spans() == profiling.Recorded([], 0)
    assert not opened


def test_spans_nest_with_parents_and_units():
    rec = profiling.Recorder()
    with _record():
        with rec.span("step", 7):
            with rec.span("step.a"):
                with rec.span("step.a.x"):
                    pass
            with rec.span("step.b", 9):
                pass
        with rec.span("other"):
            pass
    got = rec.spans()
    assert got.dropped == 0
    names = [s.name for s in got.spans]
    assert names == ["step", "step.a", "step.a.x", "step.b", "other"]
    by = _by_name(got)
    assert [s.parent for s in got.spans] == [-1, 0, 1, 0, -1]
    assert [s.unit for s in got.spans] == [7, 7, 7, 9, None]
    for s in got.spans:
        assert s.end_ns >= s.start_ns > 0 and s.syncs == 0
    step, a, x = by["step"][1], by["step.a"][1], by["step.a.x"][1]
    assert step.start_ns <= a.start_ns <= x.start_ns <= x.end_ns <= a.end_ns <= step.end_ns
    assert by["step.b"][1].start_ns >= a.end_ns


def test_thread_stacks_stay_apart():
    rec = profiling.Recorder()
    both_open = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with rec.span(f"outer.{tag}", tag):
                both_open.wait()
                with rec.span(f"inner.{tag}"):
                    both_open.wait()
        except Exception as e:  # reported below
            errors.append(e)

    with _record():
        threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    got = rec.spans()
    by = _by_name(got)
    for tag in (1, 2):
        i_outer, outer = by[f"outer.{tag}"]
        inner = by[f"inner.{tag}"][1]
        assert inner.parent == i_outer and outer.parent == -1
        assert inner.unit == outer.unit == tag


def test_the_bound_drops_and_counts():
    rec = profiling.Recorder(limit=3)
    with _record():
        for i in range(5):
            with rec.span("s", i):
                with rec.span("s.child"):
                    pass
    got = rec.spans()
    assert len(got.spans) == 3 and got.dropped == 7
    assert [s.name for s in got.spans] == ["s", "s.child", "s"]


def test_sync_warnings_count_against_the_innermost_span(recwarn):
    rec = profiling.Recorder()
    shown_before = warnings.showwarning
    with _record():
        with rec.span("outer", 1):
            with rec.span("inner"):
                for _ in range(3):  # one place: the default filter shows it once
                    warnings.warn(profiling.SYNC_WARNING + " (Triggered internally)")
            warnings.warn(profiling.SYNC_WARNING)
            warnings.warn("something else")
    got = rec.spans()
    by = _by_name(got)
    assert by["inner"][1].syncs == 3 and by["outer"][1].syncs == 1
    # the sync reports are swallowed, other warnings go on as before
    assert [str(w.message) for w in recwarn] == ["something else"]
    assert warnings.showwarning == shown_before
    assert not any(f[1] is not None and f[1].pattern == profiling.SYNC_WARNING
                   for f in warnings.filters)


def test_a_sync_outside_any_span_of_its_thread_is_not_counted():
    rec = profiling.Recorder()
    with _record():
        with rec.span("open", 1):
            t = threading.Thread(target=warnings.warn, args=(profiling.SYNC_WARNING,))
            t.start()
            t.join(timeout=60)
    assert [s.syncs for s in rec.spans().spans] == [0]


def test_trace_stops_the_recording(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("traced", 0):
            pass
    assert [s.name for s in profiling.spans().spans] == ["traced"]
    assert profiling.RECORDER._armed is None


def _tiny_step():
    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.train.step import make_train_step

    kw = dict(D=2, W=16, skips=(), use_viewdirs=True, multires=2, multires_views=1,
              output_ch=5)
    ccfg, fcfg = NeRFConfig(**kw), NeRFConfig(**kw)
    torch.manual_seed(0)
    state = create_train_state(ccfg, fcfg, "cpu", lrate=5e-4, lrate_decay=250)
    H = W = 8
    K = np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]])
    spec = PixelSamplerSpec.from_K(H, W, K, 16, single_image=True)
    rcfg = RenderConfig(N_samples=4, N_importance=4, use_viewdirs=True, near=2.0, far=6.0,
                        perturb=1.0)
    images = torch.rand(2, H, W, 3)
    poses = torch.eye(4)[None, :3, :4].repeat(2, 1, 1)
    poses[:, 2, 3] = 4.0
    return make_train_step(rcfg, ccfg, fcfg, spec), state, images, poses


def test_a_train_step_records_its_phases():
    step, state, images, poses = _tiny_step()
    step(state, images, poses, torch.Generator().manual_seed(1))  # outside: nothing
    assert not any(s.name.startswith("train_step") for s in profiling.spans().spans)
    with _record():
        aux = step(state, images, poses, torch.Generator().manual_seed(2))
    got = profiling.spans()
    assert torch.isfinite(aux["loss"])
    names = [s.name for s in got.spans]
    assert names == ["train_step", "train_step.draw", "train_step.forward",
                     "train_step.backward", "train_step.adam"]
    root = got.spans[0]
    assert root.unit == 1 and root.parent == -1
    at = root.start_ns
    for s in got.spans[1:]:
        assert s.parent == 0 and s.unit == root.unit
        assert at <= s.start_ns <= s.end_ns <= root.end_ns
        at = s.end_ns
    assert got.dropped == 0


def _tiny_service(tmp_path):
    from nerf_shared_tpu_torch.apps.serve import RenderService, serve_parser
    from nerf_shared_tpu_torch.apps.train import build_eval_engine
    from nerf_shared_tpu_torch.data.datasets import Dataset

    cfg = tmp_path / "tiny.txt"
    cfg.write_text("expname = tiny\ndataset_type = blender\nnetdepth = 2\nnetwidth = 16\n"
                   "netdepth_fine = 2\nnetwidth_fine = 16\nmultires = 2\nmultires_views = 1\n"
                   "use_viewdirs = True\nN_samples = 4\nN_importance = 4\nchunk = 40\n"
                   "white_bkgd = True\n")
    args = serve_parser().parse_args(["--config", str(cfg), "--device", "cpu",
                                      "--basedir", str(tmp_path / "logs"), "--no_reload"])
    H = W = 8
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 4.0
    ds = Dataset(images=np.zeros((0, H, W, 3), np.float32), poses=poses, render_poses=poses,
                 hwf=(H, W, 8.0), i_train=np.arange(2), i_val=np.arange(2, 3),
                 i_test=np.arange(2, 3), K=np.array([[8.0, 0, 4], [0, 8.0, 4], [0, 0, 1]]),
                 near=2.0, far=6.0)
    return RenderService(args, engine=build_eval_engine(args, ds=ds)), poses[0]


def test_a_served_frame_records_the_request(tmp_path):
    from nerf_shared_tpu_torch.apps.serve import make_server

    service, c2w = _tiny_service(tmp_path)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05})
    thread.start()
    url = "http://%s:%d" % server.server_address[:2]
    try:
        def post():
            body = json.dumps({"c2w": c2w.tolist(), "fmt": "npy"}).encode()
            req = urllib.request.Request(url + "/render", body,
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                return r.read()

        post()  # outside a recording
        with _record():
            post()
        # the handler closes request.encode and request after the response's
        # last byte is written, which the client may read first
        got = profiling.spans()
        deadline = time.monotonic() + 30
        while any(s.end_ns is None for s in got.spans) and time.monotonic() < deadline:
            time.sleep(0.01)
            got = profiling.spans()
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    assert not thread.is_alive()
    assert got.dropped == 0
    names = [s.name for s in got.spans]
    assert names == ["request", "frame", "frame.copy", "request.encode"]
    root = got.spans[0]
    assert root.unit == 1 and root.parent == -1
    assert {s.unit for s in got.spans} == {1}
    parents = {s.name: got.spans[s.parent].name for s in got.spans[1:]}
    assert parents == {"frame": "request", "frame.copy": "frame",
                       "request.encode": "request"}
    for s in got.spans:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert 'nerf_render_lock_wait_seconds{quantile="0.5"}' in text
    assert "nerf_render_frames_total 2" in text
