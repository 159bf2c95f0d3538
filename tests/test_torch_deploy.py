"""The port's deployment: Dockerfile.torch, deploy/gatekeeper-torch.yaml.

The manifest equals the JAX package's deploy/gatekeeper.yaml document by
document but for its named lines (the image, --driver=torch,
--xla-cache-dir on the baked kernels, nvidia.com/gpu in place of
google.com/tpu, the GPU nodeSelector, comments); every container's args
parse with the port's parser; the image copies only the port, installs
no jax, starts the port, and bakes the kernels with the command
chip_smoke.py's phase 16 runs (KERNEL_BAKE).  That command is run here
with a stand-in nvcc: it seals ten libraries into a 0700 directory that
a process with no nvcc loads sealed, and a process whose GK_SEAL_KEY is
not the build's refuses them and fails to start (no nvcc to rebuild),
loudly."""

import difflib
import os
import re
import stat
import subprocess
import sys

import pytest
import yaml

import chip_smoke
from gatekeeper_tpu_torch import device
from gatekeeper_tpu_torch.main import build_parser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MANIFEST = os.path.join(ROOT, "deploy", "gatekeeper.yaml")
MANIFEST = os.path.join(ROOT, "deploy", "gatekeeper-torch.yaml")
DOCKERFILE = os.path.join(ROOT, "Dockerfile.torch")
CACHE_DIR = "/var/cache/gatekeeper"
GPU_NODES = {"nvidia.com/gpu.present": "true"}


def _docs(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d]


def _containers(doc):
    if doc["kind"] != "Deployment":
        return []
    return doc["spec"]["template"]["spec"]["containers"]


def _ported(doc):
    """The JAX manifest's document with the named changes applied."""
    if doc["kind"] != "Deployment":
        return doc
    spec = doc["spec"]["template"]["spec"]
    spec["nodeSelector"].update(GPU_NODES)
    for c in spec["containers"]:
        c["image"] = "gatekeeper-tpu-torch:latest"
        i = c["args"].index("--driver=tpu")
        c["args"][i:i + 1] = ["--driver=torch", f"--xla-cache-dir={CACHE_DIR}"]
        limits = c["resources"]["limits"]
        limits["nvidia.com/gpu"] = limits.pop("google.com/tpu")
    return doc


def test_manifest_equals_the_jax_manifest_but_for_named_lines():
    want = [_ported(d) for d in _docs(JAX_MANIFEST)]
    got = _docs(MANIFEST)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (w["kind"], w["metadata"]["name"])


def test_the_text_differs_only_in_named_lines():
    with open(JAX_MANIFEST) as f:
        jax_lines = f.read().splitlines()
    with open(MANIFEST) as f:
        lines = f.read().splitlines()
    named = re.compile(
        r"^\s*(#.*"
        r"|image: gatekeeper-tpu(-torch)?:latest"
        r"|- --driver=(tpu|torch)"
        r"|- --xla-cache-dir=/var/cache/gatekeeper"
        r'|(google\.com/tpu|nvidia\.com/gpu): "1"'
        r'|nvidia\.com/gpu\.present: "true")$')
    changed = [ln for ln in difflib.ndiff(jax_lines, lines)
               if ln[:2] in ("- ", "+ ")]
    assert changed
    assert all(named.match(ln[2:]) for ln in changed), [
        ln for ln in changed if not named.match(ln[2:])]


def test_every_container_parses_with_the_ports_parser():
    containers = [c for d in _docs(MANIFEST) for c in _containers(d)]
    assert len(containers) == 2
    for c in containers:
        assert "--driver=torch" in c["args"]
        args = build_parser().parse_args(c["args"])
        assert args.driver == "torch"
        assert args.torch_device == "cuda"
        assert args.xla_cache_dir == CACHE_DIR


def test_the_manifest_requests_a_gpu_not_a_tpu():
    with open(MANIFEST) as f:
        assert "google.com/tpu" not in f.read()
    for d in _docs(MANIFEST):
        for c in _containers(d):
            assert c["resources"]["limits"]["nvidia.com/gpu"] == "1"
        if d["kind"] == "Deployment":
            sel = d["spec"]["template"]["spec"]["nodeSelector"]
            assert sel["nvidia.com/gpu.present"] == "true"


def _dockerfile():
    with open(DOCKERFILE) as f:
        text = f.read()
    # instructions, continuation lines joined
    return text, [ln for ln in re.sub(r"\\\n\s*", " ", text).splitlines()
                  if ln.strip() and not ln.lstrip().startswith("#")]


def test_the_image_copies_only_the_port():
    _text, instrs = _dockerfile()
    copies = [ln.split()[1:] for ln in instrs if ln.startswith("COPY ")]
    from_context = [c for c in copies if not c[0].startswith("--from=")]
    assert from_context == [["gatekeeper_tpu_torch/",
                             "/app/gatekeeper_tpu_torch/"]]


def test_the_image_installs_no_jax_and_starts_the_port():
    text, instrs = _dockerfile()
    installs = " ".join(ln for ln in instrs if "pip install" in ln)
    for pkg in ("torch", "numpy", "cryptography", "pyyaml"):
        assert re.search(rf"\b{pkg}\b", installs), pkg
    assert "jax" not in installs.lower()
    assert "gatekeeper_tpu/" not in text
    assert instrs[-1] == 'ENTRYPOINT ["python", "-m", "gatekeeper_tpu_torch"]'
    assert "USER 65532:65532" in instrs


def test_the_image_bakes_the_kernels_as_chip_smoke_does():
    """Dockerfile.torch's kernel build is chip_smoke.py's KERNEL_BAKE,
    into the directory the manifest's --xla-cache-dir names, owned by the
    runtime user."""
    text, instrs = _dockerfile()
    bakes = re.findall(r'python -c "([^"]*)" (\S+)', text)
    bakes = [(code, where) for code, where in bakes if "build_kernels" in code]
    assert bakes == [(chip_smoke.KERNEL_BAKE,
                      f"{CACHE_DIR}/torch_kernels")]
    assert any(f"chown -R 65532:65532 {CACHE_DIR}" in ln for ln in instrs)
    assert any(ln.startswith("COPY --from=build --chown=65532:65532 "
                             f"{CACHE_DIR} ") for ln in instrs)


def test_nvcc_links_the_cuda_runtime_statically():
    """No flag asks nvcc for a shared CUDA runtime: a library needs only
    the driver, so the runtime image needs no toolkit."""
    assert "-cudart" not in device.NVCC_FLAGS
    assert not any("cudart" in f and "static" not in f
                   for f in device.NVCC_FLAGS)


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
with open(out, "wb") as f:
    f.write(b"stand-in library of " + open(src, "rb").read()[:256])
"""

LOAD = """
import json
from gatekeeper_tpu_torch import device
device.use_cache_dir(%r)
device._build()
print(json.dumps(device.cache_log))
"""


@pytest.fixture()
def baked(tmp_path):
    """KERNEL_BAKE run as the image runs it, with a stand-in nvcc under
    CUDA_HOME -> (the library directory, a runtime environment without
    the stand-in)."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit at its default path would rebuild "
                    "the libraries the runtime case must refuse")
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    lib_dir = str(tmp_path / "var-cache" / "torch_kernels")
    env = {k: v for k, v in os.environ.items()
           if k not in ("GK_SEAL_KEY", "CUDA_HOME")}
    out = subprocess.run(
        [sys.executable, "-c", chip_smoke.KERNEL_BAKE, lib_dir],
        cwd=ROOT, env=dict(env, CUDA_HOME=str(tmp_path / "cuda")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return lib_dir, env


def _load(lib_dir, env):
    return subprocess.run([sys.executable, "-c", LOAD % lib_dir], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_the_bake_seals_ten_libraries_the_runtime_loads(baked):
    lib_dir, env = baked
    files = os.listdir(lib_dir)
    libs = [f for f in files if f.endswith(".so")]
    assert sorted(f.split("-")[0][3:] for f in libs) == sorted(
        device.KERNEL_NAMES)
    assert all(f + device.SEAL_SUFFIX in files for f in libs)
    assert stat.S_IMODE(os.stat(lib_dir).st_mode) == 0o700
    out = _load(lib_dir, env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith(
        str(dict.fromkeys(device.KERNEL_NAMES, "sealed")).replace("'", '"'))


def test_another_seal_key_refuses_the_baked_libraries_loudly(baked):
    lib_dir, env = baked
    out = _load(lib_dir, dict(env, GK_SEAL_KEY="another-key"))
    assert out.returncode != 0
    assert "nvcc not found" in out.stderr
