"""Device selection, and the build and loader of the hand-written kernels.

Every entry point of the port runs on the CUDA card unless the caller asks
for the CPU (``device="cpu"``, as the tests do).  There is no silent CPU
fallback: asking for the card without one raises.

The CUDA kernels (``kernels/*.cu``) are plain C-interface shared
libraries loaded with ``ctypes``: each source is compiled by its own
``nvcc`` process, all started together, into ``build/torch_kernels/`` at
the repository root on first use, or into ``<dir>/torch_kernels`` of the
process's ``--xla-cache-dir`` (``use_cache_dir``).  Each library file name
carries a hash of its source, the headers it includes (``kernels/*.cuh``)
and the flags, so an edited source or header is rebuilt and a stale
library is never loaded.  A loaded library runs as code, so each is
sealed when built (``<library>.seal``, an HMAC of its bytes under
``util/seal.py``'s build-stable key, ``$GK_SEAL_KEY`` when set: the file
name already tells a library of other sources apart, so an edit to the
Python code keeps the libraries): a library whose seal is missing or
fails is rebuilt, never loaded.  What is loaded is the bytes that were
verified, written to a private directory of this process, never the
shared file itself, so a library swapped in the cache directory after
its check does not run.  Each library found sealed counts as a hit of the "kernels"
cache, each build as a miss (``metrics.catalog.record_cache``), and both
are recorded with ``obs.compilestats.record_compile`` (provenance
``cold`` for a build, ``aot`` for a sealed library loaded).

Every wrapper counts its launches in ``launches`` (one per kernel launch,
nowhere else), so a run can show that its path went through the kernels.
A library may hold more than one launcher (K7's library holds its key
table and the weighted merge of per-shard tables; K8's its dense mode and
its table mode), and a launcher may be called in three modes (K9 in a
sweep, in a review where it packs the masks too, ``program_pack``, and in
a delta sweep where it writes the before | after columns too,
``program_delta``); each is counted under its own name.

A launch runs inside ``torch.cuda.device`` of its tensors' device: the C
launchers start their kernels on the CUDA runtime's current device, and on
a mesh of several cards a shard's tensors are not on the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import torch

KERNEL_NAMES = ("match", "strpred", "setcount", "reduction", "delta",
                "scatter", "joinkeys", "joinlookup", "program", "packbits")

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "kernels")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launcher name -> (library, C launcher, its parameters, one letter each:
# p pointer (or stream), i int, l 64-bit int); tests/test_torch_imports.py
# checks them against the sources
_SIGNATURES = {
    "match": ("match", "gk_match_launch", "ppii" + "p" * 13 + "iii" + "ppp"),
    "strpred": ("strpred", "gk_strpred_launch", "piipipplipp"),
    "setcount": ("setcount", "gk_setcount_launch", "ppiipiiiiiipp"),
    "reduction": ("reduction", "gk_packed_reduction_launch", "piiiiipp"),
    "delta": ("delta", "gk_delta_launch", "piipippp"),
    "scatter": ("scatter", "gk_scatter_launch", "piiillllp"),
    "joinkeys": ("joinkeys", "gk_joinkeys_launch", "pppiippiiippippp"),
    "joinkeys_merge": ("joinkeys", "gk_joinkeys_merge_launch", "ppiippippp"),
    # K8's dense mode, and its table mode: every table-mode lookup of an
    # evaluation in one launch; counted apart
    "joinlookup": ("joinlookup", "gk_joinlookup_launch", "pipiipppiipp"),
    "joinlookup_table": ("joinlookup", "gk_joinlookup_table_launch", "piip"),
    "program": ("program", "gk_program_launch", "piipiiiippipippip"),
    # K9's review mode: the same launcher with a packed output, which
    # packs the review masks in the launch (K10's work); and its delta
    # mode, with the delta sweep's before | after output (K5's work);
    # each counted apart
    "program_pack": ("program", "gk_program_launch", "piipiiiippipippip"),
    "program_delta": ("program", "gk_program_launch", "piipiiiippipippip"),
    "packbits": ("packbits", "gk_packbits_launch", "ppiiipp"),
}
LAUNCHERS = tuple(_SIGNATURES)

#: launcher name -> launches since the last reset_launches()
launches: Dict[str, int] = {name: 0 for name in LAUNCHERS}
#: kernel name -> nvcc's stderr (ptxas register / shared-memory report)
build_log: Dict[str, str] = {}
#: wall seconds of the last build (0.0 when every library was current)
build_seconds = 0.0
#: library name -> "built" or "sealed" (found sealed, loaded without
#: nvcc), for each library of the last build_kernels()
cache_log: Dict[str, str] = {}
SEAL_SUFFIX = ".seal"

_lock = threading.Lock()
_libs: Optional[Dict[str, ctypes.CDLL]] = None


def select_device(device=None) -> torch.device:
    """``None`` means the card; a CPU device only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gatekeeper_tpu_torch runs on a CUDA card by default and "
                "none is visible; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA card")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card: tensors made there report its
        # index, and the wrappers compare devices exactly
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def use_cache_dir(build_dir: str) -> str:
    """Build the kernel libraries into, and load them from, ``build_dir``
    (the App's ``--xla-cache-dir``/torch_kernels) from now on.  Libraries
    this process has loaded already stay loaded: their file names hash
    the same sources."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(build_dir)
    return BUILD_DIR


def _verified(path: str) -> Optional[bytes]:
    """The bytes of the library at ``path`` if its seal verifies against
    them (util/seal.py's build-stable key), else None."""
    from .util.seal import stable_seal

    try:
        with open(path, "rb") as f:
            data = f.read()
        with open(path + SEAL_SUFFIX, "rb") as f:
            tag = f.read().strip()
    except OSError:
        return None
    return data if hmac.compare_digest(stable_seal(data).encode(),
                                       tag) else None


def _seal(path: str, data: bytes) -> None:
    """Write the seal of ``data``, the library at ``path``, beside it,
    atomically."""
    from .util.seal import stable_seal

    tmp = f"{path}{SEAL_SUFFIX}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(stable_seal(data))
    os.replace(tmp, path + SEAL_SUFFIX)


def _load(name: str, image: bytes) -> ctypes.CDLL:
    """Load ``image``, a library's verified bytes, from a copy in a
    private (0700) directory of this process, removed once loaded."""
    tmp = tempfile.mkdtemp(prefix="gk_kernels-")
    path = os.path.join(tmp, f"gk_{name}.so")
    try:
        with open(path, "wb") as f:
            f.write(image)
        return ctypes.CDLL(path)
    finally:
        if os.path.exists(path):
            os.unlink(path)
        os.rmdir(tmp)


def _lib_path(name: str) -> str:
    """The library's path: its name and a hash of the source, every header
    it includes from ``_SRC_DIR`` (followed through the headers' own
    includes) and the flags."""
    h = hashlib.sha256()
    todo, seen = [f"{name}.cu"], set()
    while todo:
        fname = todo.pop(0)
        if fname in seen:
            continue
        seen.add(fname)
        with open(os.path.join(_SRC_DIR, fname), "rb") as f:
            text = f.read()
        h.update(fname.encode() + b"\0" + text)
        todo.extend(m.decode() for m in _INCLUDE.findall(text))
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"gk_{name}-{h.hexdigest()[:16]}.so")


def build_kernels(force: bool = False) -> Dict[str, str]:
    """Compile every kernel library that is missing or whose seal fails,
    and seal it; -> name -> path of a sealed library.  One nvcc process
    per source, all running at once."""
    return {name: path for name, (path, _image) in _build(force).items()}


def _build(force: bool = False) -> Dict[str, tuple]:
    """build_kernels(); -> name -> (path, the bytes verified or built)."""
    from .metrics.catalog import record_cache
    from .obs.compilestats import record_compile
    from .util.seal import secure_makedirs

    global build_seconds
    secure_makedirs(BUILD_DIR)
    paths = {name: _lib_path(name) for name in KERNEL_NAMES}
    images = {}
    cache_log.clear()
    for name, path in paths.items():
        t0 = time.perf_counter()
        image = None if force else _verified(path)
        if image is not None:
            images[name] = image
            cache_log[name] = "sealed"
            record_cache("kernels", True)
            record_compile(f"kernels/{name}", time.perf_counter() - t0,
                           "aot")
    todo = [name for name in KERNEL_NAMES if name not in images]
    t0 = time.perf_counter()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = f"{paths[name]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(_SRC_DIR, f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            build_log[name] = (out or "") + (err or "")
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{build_log[name]}")
                continue
            with open(tmp, "rb") as f:
                images[name] = f.read()
            os.replace(tmp, paths[name])
            _seal(paths[name], images[name])
            cache_log[name] = "built"
            record_cache("kernels", False)
            record_compile(f"kernels/{name}", time.perf_counter() - t0,
                           "cold")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
    return {name: (paths[name], images[name]) for name in KERNEL_NAMES}


def _c_args(*kinds: str):
    table = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
    return [table[k] for k in kinds]


def kernels() -> Dict[str, ctypes.CDLL]:
    """The loaded kernel libraries (library name -> CDLL), built on
    first use."""
    global _libs
    if _libs is not None:
        return _libs
    with _lock:
        if _libs is None:
            libs = {}
            # gklint: disable=blocking-under-lock -- the lock exists to
            # serialise the one-time nvcc build; concurrent first callers
            # must wait for it, and every later call returns above
            for name, (_path, image) in _build().items():
                lib = _load(name, image)
                lib.gk_error_string.argtypes = [ctypes.c_int]
                lib.gk_error_string.restype = ctypes.c_char_p
                libs[name] = lib
            for lib_name, fn_name, sig in _SIGNATURES.values():
                fn = getattr(libs[lib_name], fn_name)
                fn.argtypes = _c_args(*sig)
                fn.restype = ctypes.c_int
            _libs = libs
    return _libs


def launch(name: str, device: torch.device, *args) -> None:
    """Call launcher ``name`` on ``device``, the device of the tensors it
    launches on, made the CUDA runtime's current device for the call;
    raise on a refused launch, and count the launch."""
    lib_name, fn_name, sig = _SIGNATURES[name]
    lib = kernels()[lib_name]
    if len(args) != len(sig):  # ctypes would pass extra ones unchecked
        raise TypeError(f"{fn_name} takes {len(sig)} arguments, got {len(args)}")
    with torch.cuda.device(device):
        rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.gk_error_string(rc).decode()
        raise RuntimeError(f"kernel {name} launch failed: {msg} ({rc})")
    launches[name] += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pinned_empty(nbytes: int) -> torch.Tensor:
    """A page-locked uint8 host buffer, the source of an asynchronous
    copy to the card.  PyTorch's host allocator keeps a block whose copy
    is still in flight until that copy is done, so a buffer dropped after
    ``.to(dev, non_blocking=True)`` is never rewritten under the copy; a
    caller that keeps and refills one must wait for it itself."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def upload(array, dev: torch.device) -> torch.Tensor:
    """A copy of the host array ``array`` on ``dev``, staged through
    pinned memory and not waited for: work queued after it on ``dev``'s
    stream runs after the copy."""
    import numpy as np

    a = np.ascontiguousarray(array)
    host = pinned_empty(a.nbytes)
    host.numpy()[:] = a.reshape(-1).view(np.uint8)
    return host.view(torch.from_numpy(a[:0]).dtype).view(a.shape).to(
        dev, non_blocking=True)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """What every kernel wrapper demands of an input tensor."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
