"""The port stands alone: gatekeeper_tpu_torch and chip_smoke.py import
neither JAX nor anything of gatekeeper_tpu, every module imports with both
blocked, and the entry points refuse to run on the CPU unless asked."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "gatekeeper_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gatekeeper_tpu")


def _port_files():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "tools").glob("*_torch.py"))
    assert len(files) > 30
    return files


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    bad = [r for r in _imported_roots(path) if r in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_and_the_reference_blocked():
    modules = [_module_name(p) for p in sorted(PKG.rglob("*.py"))]
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'gatekeeper_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_torch_driver_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDriver()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TorchDriver(device="cuda")
    assert TorchDriver(device="cpu").device.type == "cpu"


def test_every_kernel_has_a_source_with_its_note():
    from gatekeeper_tpu_torch import device

    assert {"program", "packbits"} <= set(device.KERNEL_NAMES)
    for name in device.KERNEL_NAMES:
        src = (PKG / "kernels" / f"{name}.cu").read_text()
        assert "Replaces gatekeeper_tpu/" in src, name
        assert "What bounds it" in src, name
        assert "extern \"C\" int gk_" in src, name
        assert "gk_error_string" in src, name


def test_ctypes_signatures_match_the_c_launchers():
    """A pointer passed where the C side takes an int (or the reverse) is
    cut to 32 bits by ctypes: the argument lists must agree exactly."""
    import re

    from gatekeeper_tpu_torch import device

    libraries = {lib for lib, _fn, _sig in device._SIGNATURES.values()}
    assert libraries == set(device.KERNEL_NAMES)
    assert device._SIGNATURES["program"][1] == "gk_program_launch"
    assert device._SIGNATURES["packbits"] == (
        "packbits", "gk_packbits_launch", "ppiiipp")
    for name, (lib, fn_name, sig) in device._SIGNATURES.items():
        src = (PKG / "kernels" / f"{lib}.cu").read_text()
        launchers = re.findall(r'extern "C" int (gk_\w+_launch)\(', src)
        assert fn_name in launchers, name
        m = re.search(
            rf'extern "C" int ({fn_name})\((.*?)\)\s*\{{', src, re.S
        )
        assert m, name
        params = [p.strip() for p in m.group(2).split(",")]
        want = "".join(
            "p" if "*" in p else "l" if "long long" in p else "i"
            for p in params
        )
        assert sig == want, (name, sig, want)
    # and every launcher of every source has its signature
    every = {
        fn for lib in libraries for fn in re.findall(
            r'extern "C" int (gk_\w+_launch)\(',
            (PKG / "kernels" / f"{lib}.cu").read_text())
    }
    assert every == {fn for _l, fn, _s in device._SIGNATURES.values()}


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors no kernel is built or launched (there is no nvcc
    here): the wrappers run their plain versions and count nothing."""
    from gatekeeper_tpu_torch import device
    from gatekeeper_tpu_torch.ops import progcode, vexpr
    from gatekeeper_tpu_torch.ops.packbits import pack_review_masks
    from gatekeeper_tpu_torch.ops.program import bind_group, program_eval
    from gatekeeper_tpu_torch.ops.reduction import packed_reduction
    from gatekeeper_tpu_torch.ops.setcount import setcount
    from gatekeeper_tpu_torch.ops.strpred import strpred

    device.reset_launches()
    mask = torch.zeros((2, 64), dtype=torch.bool)
    mask[1, 5] = True
    assert packed_reduction(mask, 3).tolist() == [
        [0, -1, -1, -1], [1, 5, -1, -1],
    ]
    packed = pack_review_masks(mask[:, :10], ~mask[:, :10])
    assert packed.dtype == torch.uint8 and packed.tolist() == [
        [0, 0], [4, 0], [255, 192], [251, 192],
    ]
    table = torch.tensor([[0, 1], [1, 0], [1, 1]], dtype=torch.uint8)
    hit = strpred(
        table, torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([[5, 5, 0]], dtype=torch.int8),
        torch.tensor([[0, 1, 2]], dtype=torch.int32),
    )
    assert hit.tolist() == [[False, True, False], [True, False, False]]
    cnt = setcount(
        torch.tensor([[3, 4]], dtype=torch.int32),
        torch.tensor([[True, True]]),
        torch.tensor([[3, -2], [7, 8]], dtype=torch.int32), 0, 0, 0, -2,
    )
    assert cnt.tolist() == [[True, True]]
    col = ("scalar", (), ("a",), ())
    env = vexpr.EvalEnv(
        {col: {"tcode": torch.tensor([4, 4, 0], dtype=torch.int8),
               "sid": torch.tensor([-1, -1, -1], dtype=torch.int32),
               "num": torch.tensor([1.0, 3.0, 0.0], dtype=torch.float64)}},
        {}, {}, {}, {}, 1, 3, "cpu")
    prog = vexpr.VProgram([vexpr.Clause((vexpr.Cmp(
        ">", vexpr.ColRef(col, False), vexpr.Lit(2)),))], [], [], [])
    mask = torch.ones((2, 3), dtype=torch.bool)
    program_eval(mask, [bind_group(progcode.encode(prog), env, 1)])
    assert mask.tolist() == [[True, True, True], [False, True, False]]
    assert all(v == 0 for v in device.launches.values())


def test_a_changed_header_changes_the_library_path(tmp_path, monkeypatch):
    """A library's file name hashes the headers its source includes: an
    edited .cuh rebuilds every kernel that includes it, and only those."""
    import shutil

    from gatekeeper_tpu_torch import device

    src = tmp_path / "kernels"
    shutil.copytree(PKG / "kernels", src)
    monkeypatch.setattr(device, "_SRC_DIR", str(src))
    before = {n: device._lib_path(n) for n in device.KERNEL_NAMES}
    assert before == {n: device._lib_path(n) for n in device.KERNEL_NAMES}
    header = src / "strpred.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: device._lib_path(n) for n in device.KERNEL_NAMES}
    changed = {n for n in device.KERNEL_NAMES if after[n] != before[n]}
    assert changed == {"strpred", "program"}
    header = src / "setcount.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    again = {n: device._lib_path(n) for n in device.KERNEL_NAMES}
    assert {n for n in device.KERNEL_NAMES
            if again[n] != after[n]} == {"setcount", "program"}


def test_the_pack_header_rebuilds_k9_and_k10(tmp_path, monkeypatch):
    """packbits.cuh is K10's body and K9's review-mode pack: an edit of it
    rebuilds both libraries, and only those."""
    import shutil

    from gatekeeper_tpu_torch import device

    src = tmp_path / "kernels"
    shutil.copytree(PKG / "kernels", src)
    monkeypatch.setattr(device, "_SRC_DIR", str(src))
    before = {n: device._lib_path(n) for n in device.KERNEL_NAMES}
    header = src / "packbits.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    changed = {n for n in device.KERNEL_NAMES
               if device._lib_path(n) != before[n]}
    assert changed == {"packbits", "program"}
    # K9's two modes are one C launcher, counted apart
    assert device._SIGNATURES["program_pack"] == device._SIGNATURES[
        "program"]
    assert {"program", "program_pack"} <= set(device.launches)
