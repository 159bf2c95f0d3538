"""The device profiler behind ``--jax-profile-port``
(gatekeeper_tpu_torch/obs/devprof.py), on the CPU.

Checked: an App with ``--torch-device cpu --jax-profile-port P`` starts
the listener, ``stop()`` frees the port and a second App starts on it; a
capture around one admission holds that review's ``tpu.pack``,
``tpu.dispatch`` and ``render`` spans inside the window on the trace's
clock; a capture while another session holds the process answers 409,
a bad ``ms`` 400; ``/memory`` on the CPU; the kernel-symbol map read
from the sources covers every launcher of ``device._SIGNATURES`` with
the K number of each kernel; the summary's counts, busy share and gaps
on a synthetic timeline; and the no-fallback rule: on ``cuda`` a trace
with no CUDA kernel event while the launch counters moved is a 500."""

import json
import os
import socket
import ssl
import threading
import time
import urllib.error
import urllib.request

import pytest

from gatekeeper_tpu_torch import device
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.main import App, build_parser
from gatekeeper_tpu_torch.obs import devprof

from .test_torch_controllers import CONSTRAINT, TEMPLATE

# each library's kernels, as the port's sources name them: a renamed or
# added kernel fails here before it drops out of a capture's summary
KERNEL_SYMBOLS = {
    ("match_kernel", "Layout"): "K1",
    ("strpred_kernel", "uint8_t"): "K2",
    ("setcount_kernel", "int"): "K3",
    ("packed_reduction_kernel", "uint8_t"): "K4",
    ("delta_columns_kernel", "uint8_t"): "K5",
    ("scatter_rows_kernel", "uint8_t"): "K6",
    ("table_kernel", "Args"): "K7",
    ("table_kernel", "Lookups"): "K8",
    ("dense_kernel", "int"): "K8",
    ("program_kernel", "long"): "K9",
    ("packbits_kernel", "uint8_t"): "K10",
}
# the names Kineto gives CUDA kernels (demangled; mangled where it could
# not demangle), with the K number each must be counted under
EVENT_NAMES = [
    ("(anonymous namespace)::match_kernel((anonymous namespace)::Layout, "
     "int const*, int, int, int, int, int const*)", "K1"),
    ("void (anonymous namespace)::table_kernel<false>((anonymous "
     "namespace)::Args)", "K7"),
    ("void (anonymous namespace)::table_kernel<true>((anonymous "
     "namespace)::Args)", "K7"),
    ("(anonymous namespace)::table_kernel((anonymous namespace)::Lookups, "
     "int)", "K8"),
    ("_ZN12_GLOBAL__N_112table_kernelILb0EEEvNS_4ArgsE", "K7"),
    ("_ZN12_GLOBAL__N_112table_kernelENS_7LookupsEi", "K8"),
    ("void (anonymous namespace)::dense_kernel<true>(int const*, int)", "K8"),
    ("void (anonymous namespace)::program_kernel<8, 32, true>(long long "
     "const*, int, int, unsigned char*)", "K9"),
    ("(anonymous namespace)::packbits_kernel(unsigned char const*)", "K10"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<int>>(int)", None),
    ("ampere_sgemm_128x64_tn", None),
]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(port: int, path: str, timeout: float = 60):
    """GET ``path`` -> (status, JSON body)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def await_capturing(port: int):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if get(port, "/status")[1]["capturing"]:
            return
        time.sleep(0.01)
    raise AssertionError("the capture never started")


class Capture(threading.Thread):
    """One GET /capture in a thread; ``result`` its (status, body)."""

    def __init__(self, port: int, ms: int):
        super().__init__()
        self.port, self.ms, self.result = port, ms, None

    def run(self):
        self.result = get(self.port, f"/capture?ms={self.ms}")


def make_app(tmp_path, port: int, kube=None):
    flags = ["--driver", "torch", "--torch-device", "cpu",
             "--port", "0", "--prometheus-port", "0", "--health-addr", ":0",
             "--audit-interval", "3600", "--log-level", "WARNING",
             "--cert-dir", str(tmp_path / "certs"),
             "--jax-profile-port", str(port),
             # the process-global brownout ladder, fed by other tests'
             # slow admissions in this process, would thin the tracer
             "--brownout-disable"]
    app = App(build_parser().parse_args(flags), kube=kube or InMemoryKube())
    # the review below takes the device path (compute_masks, K1 and K9's
    # plain versions here), and the App skips its calibration
    app.client.driver.DEVICE_MIN_CELLS = 0
    return app


def post_admit(app, request: dict) -> dict:
    body = json.dumps({"request": request}).encode()
    ctx, scheme = None, "http"
    if app.rotator is not None:
        scheme = "https"
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    r = urllib.request.Request(
        f"{scheme}://127.0.0.1:{app.webhook_server.port}/v1/admit",
        data=body)
    with urllib.request.urlopen(r, context=ctx, timeout=30) as resp:
        return json.loads(resp.read())


def test_the_app_serves_the_profiler_and_frees_its_port(tmp_path):
    port = free_port()
    for i in range(2):  # the second App binds the port the first freed
        app = make_app(tmp_path, port)
        app.start()
        try:
            assert app.device_profile_server.port == port
            code, st = get(port, "/status")
            assert code == 200 and st == {"device": "cpu",
                                          "capturing": False,
                                          "busy": False, "captures": 0}
            assert get(port, "/nowhere")[0] == 404
        finally:
            app.stop()
        assert app.device_profile_server is None
        with socket.socket() as s:  # nothing listens any more
            assert s.connect_ex(("127.0.0.1", port)) != 0


def test_a_capture_holds_the_reviews_spans_on_its_clock(tmp_path):
    port = free_port()
    kube = InMemoryKube()
    app = make_app(tmp_path, port, kube)
    app.start()
    try:
        kube.create(json.loads(json.dumps(TEMPLATE)))
        assert app.manager.drain()
        kube.create(json.loads(json.dumps(CONSTRAINT)))
        assert app.manager.drain()
        cap = Capture(port, 4000)
        cap.start()
        await_capturing(port)
        out = post_admit(app, {
            "uid": "u1",
            "kind": {"group": "", "version": "v1", "kind": "Namespace"},
            "name": "bad-ns", "namespace": "", "operation": "CREATE",
            "userInfo": {"username": "alice"},
            "object": {"apiVersion": "v1", "kind": "Namespace",
                       "metadata": {"name": "bad-ns", "labels": {}}},
        })
        # the review fell inside the window (a loaded host can stretch it)
        assert get(port, "/status")[1]["capturing"], \
            "the admission outlasted the capture's window"
        cap.join(60)
    finally:
        app.stop()
    assert out["response"]["allowed"] is False
    code, trace = cap.result
    assert code == 200, trace
    summary = trace["gk_summary"]
    assert summary["device"] == "cpu" and summary["ms_asked"] == 4000
    assert summary["events_dropped"] == 0
    # the marker's perf_counter reads and its Kineto times agree
    assert summary["alignment_error_us"] < 1000
    (mark,) = [e for e in trace["traceEvents"]
               if e.get("name") == devprof.MARKER]
    w0, w1 = mark["ts"], mark["ts"] + mark["dur"]
    assert summary["window_ms"] == pytest.approx(mark["dur"] / 1e3)
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "gk_span"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("tpu.pack", "tpu.dispatch", "render"):
        assert name in by_name, sorted(by_name)
        for e in by_name[name]:
            assert w0 <= e["ts"] and e["ts"] + e["dur"] <= w1, (name, e)
    # pack, then dispatch, then the render, on one trace
    pack, disp = by_name["tpu.pack"][0], by_name["tpu.dispatch"][0]
    assert pack["args"]["trace_id"] == disp["args"]["trace_id"]
    assert pack["ts"] <= disp["ts"] <= by_name["render"][0]["ts"]
    # every span on a named thread's row, the rows named by metadata
    rows = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("pid") == devprof.SPAN_PID}
    assert {e["tid"] for e in spans} <= set(rows)
    assert all(e["args"]["thread"] == rows[e["tid"]] for e in spans)
    assert summary["span_events"] == len(spans)
    assert {r["name"] for r in summary["spans"]} >= {"tpu.pack",
                                                     "tpu.dispatch"}
    # no card: no kernel event, nothing busy
    assert summary["device_busy_ms"] == 0.0 and summary["gaps"] == []
    assert all(k["count"] == 0 for k in summary["kernels"].values())


def test_a_second_session_gets_409_and_a_bad_ms_400():
    server = devprof.DeviceProfileServer(0, "cpu").start()
    try:
        port = server.port
        for bad in ("0", "10001", "abc", "-5"):
            code, body = get(port, f"/capture?ms={bad}")
            assert code == 400 and "ms must be" in body["error"]
        cap = Capture(port, 800)
        cap.start()
        await_capturing(port)
        code, body = get(port, "/capture?ms=5")
        assert code == 409 and "active" in body["error"]
        cap.join(60)
        assert cap.result[0] == 200
        # a session of other code of the process (chip_smoke --profile
        # takes the same lock) holds it too
        from torch.profiler import ProfilerActivity, profile

        with devprof.exclusive(), profile(
                activities=[ProfilerActivity.CPU]):
            assert get(port, "/capture?ms=5")[0] == 409
            assert get(port, "/status")[1]["busy"] is True
        assert get(port, "/capture?ms=5")[0] == 200
        assert get(port, "/status")[1]["captures"] == 2
    finally:
        server.stop()


def test_memory_on_the_cpu():
    server = devprof.DeviceProfileServer(0, "cpu").start()
    try:
        code, body = get(server.port, "/memory")
    finally:
        server.stop()
    assert code == 200
    assert body["device"] == "cpu" and body["card"] is None
    assert "allocated_bytes" not in body


def test_the_symbol_map_covers_every_launcher_from_the_sources():
    symbols = devprof.kernel_symbols()
    assert symbols == KERNEL_SYMBOLS
    libraries = {sig[0] for sig in device._SIGNATURES.values()}
    assert libraries == set(devprof.K_OF_LIBRARY) == set(device.KERNEL_NAMES)
    assert sorted(set(symbols.values()), key=lambda k: int(k[1:])) == \
        list(devprof.KERNELS)
    for name, want in EVENT_NAMES:
        assert devprof.classify(name, symbols) == want, name


def test_a_renamed_kernel_is_read_from_its_source(tmp_path):
    """The map is the sources': a kernel renamed in its file is counted
    under the new name (and the table above fails until it is updated)."""
    kernels = os.path.join(os.path.dirname(device.__file__), "kernels")
    for name in sorted(device.KERNEL_NAMES):
        with open(os.path.join(kernels, f"{name}.cu")) as f:
            text = f.read()
        if name == "match":
            text = text.replace("match_kernel(", "match_rows_kernel(")
        (tmp_path / f"{name}.cu").write_text(text)
    symbols = devprof.kernel_symbols(str(tmp_path))
    assert ("match_rows_kernel", "Layout") in symbols
    assert ("match_kernel", "Layout") not in symbols
    assert devprof.classify("(anonymous namespace)::match_rows_kernel("
                            "(anonymous namespace)::Layout)", symbols) == "K1"


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_the_summary_counts_kernels_busy_time_and_gaps():
    symbols = devprof.kernel_symbols()
    k1 = EVENT_NAMES[0][0]
    k9 = EVENT_NAMES[7][0]
    events = [
        _kernel(k1, 100.0, 10.0), _kernel(k9, 110.0, 30.0),   # busy 40
        _kernel(k1, 500.0, 20.0),                             # gap 360
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 600.0, "dur": 5.0},                            # gap 80
        _kernel("void other_kernel<int>(int)", 900.0, 100.0),  # gap 295
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 2000.0},
    ]
    spans = [{"name": "audit.dispatch", "ts": 90.0, "dur": 460.0,
              "args": {"thread": "audit"}},
             {"name": "render", "ts": 620.0, "dur": 200.0,
              "args": {"thread": "audit"}}]
    s = devprof.summarize(events, (0.0, 1000.0), spans, symbols,
                          {"match": 2, "program": 1, "reduction": 0})
    assert s["window_ms"] == 1.0
    assert s["kernels"]["K1"] == {"count": 2, "total_us": 30.0,
                                  "median_us": 15.0}
    assert s["kernels"]["K9"]["count"] == 1
    assert s["kernels"]["K4"] == {"count": 0, "total_us": 0,
                                  "median_us": None}
    # a kernel the port did not write counts as busy, under no K
    assert sum(k["count"] for k in s["kernels"].values()) == 3
    assert s["device_busy_ms"] == pytest.approx(0.165)
    assert s["busy_share"] == pytest.approx(0.165)
    assert [g["ms"] for g in s["gaps"]] == pytest.approx([0.36, 0.295,
                                                          0.08])
    assert s["gaps"][0]["start_ms"] == pytest.approx(0.14)
    assert [x["name"] for x in s["gaps"][0]["spans"]] == ["audit.dispatch"]
    assert [x["name"] for x in s["gaps"][1]["spans"]] == ["render"]
    rows = {r["name"]: r for r in s["spans"]}
    assert rows["audit.dispatch"]["device_busy_ms"] == pytest.approx(0.06)
    assert s["launches"] == {"match": 2, "program": 1}


class _NoKernelsProfile:
    """A stand-in for torch.profiler.profile on a card whose trace holds
    the window's marker and no CUDA kernel event."""

    def __init__(self, activities):
        self.activities = activities

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": [
                {"ph": "X", "cat": "user_annotation", "name": devprof.MARKER,
                 "ts": 10.0, "dur": 5000.0},
                {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": 20.0, "dur": 3.0},
            ]}, f)


def test_on_the_card_no_kernel_events_after_launches_is_a_500(monkeypatch):
    import torch
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA})
    counts = iter([{"match": 5, "program_pack": 5},
                   {"match": 6, "program_pack": 6}])
    monkeypatch.setattr(devprof, "_launch_counts", lambda: next(counts))
    server = devprof.DeviceProfileServer(
        0, "cuda", profiler_factory=_NoKernelsProfile).start()
    try:
        code, body = get(server.port, "/capture?ms=20")
    finally:
        server.stop()
    assert code == 500
    assert "no CUDA kernel event" in body["error"]
    assert "'match': 1" in body["error"]
    assert "traceEvents" not in body


def test_on_the_card_without_cupti_a_capture_is_a_500(monkeypatch):
    import torch
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    server = devprof.DeviceProfileServer(0, "cuda").start()
    try:
        code, body = get(server.port, "/capture?ms=20")
    finally:
        server.stop()
    assert code == 500 and "no CPU-only trace" in body["error"]
