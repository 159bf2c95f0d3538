"""The kernels' sealed build cache (gatekeeper_tpu_torch/device.py), the
port's counterpart of the JAX package's compile caches behind
``--xla-cache-dir``, tested without nvcc.

A stand-in compiler (a Python script taking nvcc's arguments) writes each
"library", and ``ctypes.CDLL`` is replaced by a recorder that notes what
it was asked to load.  Checked: the flag resolving the build directory;
seal and verify on a stand-in file; a first process building and sealing
all ten libraries and a second loading them with no compiler run (ten
cache hits), also after an edit to the Python code; a library whose
bytes or seal fail being rebuilt, never handed to ``CDLL``; a library
swapped in the directory after its check never loaded; a failed build
raising; and no flag of the JAX App refused any more."""

import ctypes
import os
import stat
import sys

import pytest

from gatekeeper_tpu_torch import device
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch import main as gmain
from gatekeeper_tpu_torch.main import App, build_parser
from gatekeeper_tpu_torch.metrics.views import global_registry
from gatekeeper_tpu_torch.obs import compilestats
from gatekeeper_tpu_torch.util import seal as sealmod

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
if "{fail}" and src.endswith("{fail}"):
    sys.stderr.write("error: stand-in failure\\n")
    sys.exit(1)
with open(out, "wb") as f:
    f.write(b"stand-in library of " + open(src, "rb").read()[:256])
with open("{log}", "a") as f:
    f.write(src.rsplit("/", 1)[-1] + "\\n")
"""


class Loads:
    """ctypes.CDLL stood in for: each call's path and the bytes of the
    file there when it was loaded."""

    class Lib:
        def __init__(self):
            self._fns = {}

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            return self._fns.setdefault(name, type("Fn", (), {})())

    def __init__(self):
        self.calls = []

    def __call__(self, path, *a, **k):
        with open(path, "rb") as f:
            self.calls.append((path, f.read()))
        return self.Lib()


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """An empty build cache under tmp_path, the stand-in compiler, the
    CDLL recorder, and no library loaded in this process."""
    log = tmp_path / "nvcc.log"

    def compiler(fail=""):
        path = tmp_path / f"nvcc{fail and '-fail'}"
        path.write_text(FAKE_NVCC.format(python=sys.executable, log=log,
                                         fail=fail))
        path.chmod(path.stat().st_mode | stat.S_IXUSR)
        return str(path)

    monkeypatch.setattr(device, "BUILD_DIR", device.BUILD_DIR)
    monkeypatch.setattr(device, "_libs", None)
    monkeypatch.setattr(device, "build_seconds", device.build_seconds)
    nvcc = compiler()
    monkeypatch.setattr(device, "_nvcc", lambda: nvcc)
    loads = Loads()
    monkeypatch.setattr(ctypes, "CDLL", loads)
    build_dir = device.use_cache_dir(str(tmp_path / "cache" / "torch_kernels"))

    class Cache:
        dir = build_dir

        @staticmethod
        def compiled():
            return log.read_text().split() if log.exists() else []

        @staticmethod
        def fresh_process():
            """As a new process: nothing loaded, the log emptied."""
            monkeypatch.setattr(device, "_libs", None)
            if log.exists():
                log.unlink()
            loads.calls.clear()

    Cache.loads = loads
    Cache.compiler = staticmethod(compiler)
    yield Cache


def _hits_misses():
    rows = global_registry().view_rows("cache_requests_total")
    return (rows.get(("kernels", "hit"), 0), rows.get(("kernels", "miss"), 0))


def _loaded_sealed(cache) -> bool:
    """Every library CDLL loaded is the bytes of a sealed library of the
    cache, from a private copy outside it that is gone once loaded."""
    sealed = {device._verified(device._lib_path(n))
              for n in device.KERNEL_NAMES}
    return all(image in sealed and not path.startswith(cache.dir)
               and not os.path.exists(path)
               for path, image in cache.loads.calls)


def test_the_flag_resolves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(device, "BUILD_DIR", device.BUILD_DIR)
    default = device.BUILD_DIR
    assert default.endswith(os.path.join("build", "torch_kernels"))
    args = build_parser().parse_args([
        "--torch-device", "cpu", "--xla-cache-dir", str(tmp_path),
        "--log-level", "WARNING"])
    App(args, kube=InMemoryKube())
    want = str(tmp_path / "torch_kernels")
    assert device.BUILD_DIR == want
    assert all(os.path.dirname(device._lib_path(n)) == want
               for n in device.KERNEL_NAMES)
    # without the flag the directory stays where it was
    monkeypatch.setattr(device, "BUILD_DIR", default)
    App(build_parser().parse_args(["--torch-device", "cpu",
                                   "--log-level", "WARNING"]),
        kube=InMemoryKube())
    assert device.BUILD_DIR == default


def test_seal_and_verify_on_a_stand_in_file(tmp_path, monkeypatch):
    lib = tmp_path / "gk_x-0123.so"
    data = b"\x7fELF stand-in"
    lib.write_bytes(data)
    assert device._verified(str(lib)) is None  # no seal yet
    device._seal(str(lib), data)
    seal_path = str(lib) + device.SEAL_SUFFIX
    assert os.path.exists(seal_path)
    assert device._verified(str(lib)) == data
    tag = open(seal_path).read()
    assert tag == sealmod.stable_seal(data)
    # another key (a deployment's GK_SEAL_KEY) does not verify it
    monkeypatch.setenv("GK_SEAL_KEY", "another-deployment")
    assert device._verified(str(lib)) is None
    monkeypatch.delenv("GK_SEAL_KEY")
    # an edit to the package's Python code (another code fingerprint)
    # leaves it verified: the library's file name hashes its sources
    monkeypatch.setattr(sealmod, "_code_fp", "another build")
    assert device._verified(str(lib)) == data
    # one byte of the library, or of the seal, changed
    lib.write_bytes(b"\x7fELF stand-iN")
    assert device._verified(str(lib)) is None
    lib.write_bytes(data)
    with open(seal_path, "w") as f:
        f.write(("0" if tag[0] != "0" else "1") + tag[1:])
    assert device._verified(str(lib)) is None
    with open(seal_path, "wb") as f:  # not a hex digest at all
        f.write("é".encode() + b"\xff" * 8)
    assert device._verified(str(lib)) is None
    os.unlink(seal_path)
    assert device._verified(str(lib)) is None


def test_a_second_process_loads_the_sealed_libraries_without_nvcc(cache):
    hits0, misses0 = _hits_misses()
    mix0 = compilestats.get_stats().provenance_mix()
    device.kernels()
    assert sorted(cache.compiled()) == sorted(
        f"{n}.cu" for n in device.KERNEL_NAMES)
    assert device.cache_log == dict.fromkeys(device.KERNEL_NAMES, "built")
    assert len(cache.loads.calls) == len(device.KERNEL_NAMES)
    assert _loaded_sealed(cache)
    for name in device.KERNEL_NAMES:
        path = device._lib_path(name)
        assert path.startswith(cache.dir + os.sep)
        assert os.path.exists(path + device.SEAL_SUFFIX)
    assert os.stat(cache.dir).st_mode & 0o777 == 0o700
    assert _hits_misses() == (hits0, misses0 + 10)

    cache.fresh_process()
    device._nvcc = None  # any compiler run would raise
    device.kernels()
    assert cache.compiled() == []
    assert device.cache_log == dict.fromkeys(device.KERNEL_NAMES, "sealed")
    assert len(cache.loads.calls) == len(device.KERNEL_NAMES)
    assert _loaded_sealed(cache)
    assert _hits_misses() == (hits0 + 10, misses0 + 10)
    mix = compilestats.get_stats().provenance_mix()
    for name in device.KERNEL_NAMES:
        assert mix.get(f"kernels/{name}|cold", 0) == \
            mix0.get(f"kernels/{name}|cold", 0) + 1
        assert mix.get(f"kernels/{name}|aot", 0) == \
            mix0.get(f"kernels/{name}|aot", 0) + 1


@pytest.mark.parametrize("corrupt", ["library", "seal", "no_seal"])
def test_a_library_whose_seal_fails_is_rebuilt_never_loaded(cache, corrupt):
    device.kernels()
    path = device._lib_path("match")
    seal_path = path + device.SEAL_SUFFIX
    if corrupt == "library":
        with open(path, "ab") as f:
            f.write(b" and a payload")
    elif corrupt == "seal":
        with open(seal_path, "w") as f:
            f.write("0" * 64)
    else:
        os.unlink(seal_path)
    bad = open(path, "rb").read()
    cache.fresh_process()
    device.kernels()
    assert cache.compiled() == ["match.cu"]
    assert device.cache_log["match"] == "built"
    assert all(device.cache_log[n] == "sealed"
               for n in device.KERNEL_NAMES if n != "match")
    # every library CDLL saw verified when it was loaded, and the
    # library that failed its seal was replaced first
    assert len(cache.loads.calls) == len(device.KERNEL_NAMES)
    assert _loaded_sealed(cache)
    if corrupt == "library":
        assert bad not in {image for _p, image in cache.loads.calls}
        assert open(path, "rb").read() != bad
    assert device._verified(path) is not None


def test_an_edit_to_the_python_code_keeps_the_sealed_libraries(
        cache, monkeypatch):
    device.kernels()
    cache.fresh_process()
    monkeypatch.setattr(sealmod, "_code_fp", "another build")
    device._nvcc = None  # any compiler run would raise
    device.kernels()
    assert cache.compiled() == []
    assert device.cache_log == dict.fromkeys(device.KERNEL_NAMES, "sealed")


def test_a_library_swapped_after_its_check_never_loads(cache, monkeypatch):
    """The bytes loaded are the bytes verified: a library replaced in the
    shared directory between the check and the load does not run."""
    device.kernels()
    cache.fresh_process()
    build = device._build

    def then_swapped(*a, **k):
        out = build(*a, **k)
        for path, _image in out.values():
            with open(path, "wb") as f:
                f.write(b"a payload")
        return out

    monkeypatch.setattr(device, "_build", then_swapped)
    device.kernels()
    assert len(cache.loads.calls) == len(device.KERNEL_NAMES)
    assert all(image.startswith(b"stand-in library of ")
               for _p, image in cache.loads.calls)


def test_a_failed_build_raises_and_loads_nothing(cache):
    failing = cache.compiler(fail="program.cu")
    device._nvcc = lambda: failing
    with pytest.raises(RuntimeError, match="(?s)kernel build failed.*program"):
        device.kernels()
    assert cache.loads.calls == []
    assert device._libs is None
    assert device._verified(device._lib_path("program")) is None


def test_the_flags_that_stay_refused_name_their_roadmap_items():
    """None stays refused: the last (``--jax-profile-port``, ROADMAP A8)
    now constructs an App, and ``--xla-cache-dir`` beside it still
    points the kernels' cache where it did."""
    assert not hasattr(gmain, "UNPORTED_FLAGS")
    app = App(build_parser().parse_args(
        ["--torch-device", "cpu", "--log-level", "WARNING",
         "--jax-profile-port", "1"]), kube=InMemoryKube())
    assert app.args.jax_profile_port == 1
    assert "torch.profiler" in build_parser().format_help().replace(
        "\n", " ")
