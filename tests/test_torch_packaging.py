"""The port's wheel carries what its kernels build from: every source
device.py compiles (``kernels/<name>.cu``) and every header those sources
include, followed through the headers' own includes (device.py's
``_INCLUDE``), matches a package-data glob of pyproject.toml for
``gatekeeper_tpu_torch.kernels``.  A header left out would make K9, K10,
K2 and K3 fail to build from an installed package."""

import fnmatch
import os
import pathlib
import tomllib

import pytest

from gatekeeper_tpu_torch import device

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNELS = ROOT / "gatekeeper_tpu_torch" / "kernels"


def _package_globs() -> list:
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)
    return data["tool"]["setuptools"]["package-data"][
        "gatekeeper_tpu_torch.kernels"]


def _build_inputs(name: str) -> list:
    """The files device.py reads to build ``name``'s library."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        fname = todo.pop(0)
        if fname in seen:
            continue
        seen.append(fname)
        todo.extend(m.decode() for m in device._INCLUDE.findall(
            (KERNELS / fname).read_bytes()))
    return seen


@pytest.mark.parametrize("name", device.KERNEL_NAMES)
def test_every_kernel_source_and_header_is_packaged(name):
    globs = _package_globs()
    inputs = _build_inputs(name)
    missing = [f for f in inputs
               if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missing, f"{name}: {missing} match none of {globs}"


def test_the_headers_are_the_ones_the_sources_include():
    """Every header in kernels/ is included by some source (so the globs
    above see each one), and the package's kernels directory holds
    nothing a glob leaves out but Python modules."""
    included = {f for name in device.KERNEL_NAMES
                for f in _build_inputs(name) if f.endswith(".cuh")}
    assert included == {p.name for p in KERNELS.glob("*.cuh")}
    assert included >= {"packbits.cuh", "setcount.cuh", "strpred.cuh"}
    globs = _package_globs()
    left_out = [p for p in os.listdir(KERNELS)
                if not p.endswith(".py") and p != "__pycache__"
                and not any(fnmatch.fnmatch(p, g) for g in globs)]
    assert not left_out, left_out
