"""The port's multi-process sweep (gatekeeper_tpu_torch/parallel/
multihost.py): two REAL OS processes joined with torch.distributed on gloo
over loopback, each with a 2-slot virtual mesh of the CPU
(GK_VIRTUAL_DEVICES=2), one global width of 4.  Each process's capped
sweep must equal the single-process sweep bit for bit, counts and first
candidates, as tests/test_multihost.py holds the JAX package's.  A
referential corpus is refused, as there."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GK_REPO"])
import numpy as np
import torch.distributed as dist
from gatekeeper_tpu_torch.parallel.multihost import (
    init_distributed, multihost_capped_sweep, multihost_layout,
)
from gatekeeper_tpu_torch.util import synthetic as syn

pid = int(os.environ["GK_PROC"])
init_distributed(os.environ["GK_COORD"], 2, pid)
try:
    # every process replicates the same store (derived state)
    driver = syn.build_driver(10, 200, seed=0, device="cpu").driver
    mesh, first, width = multihost_layout("cpu")
    assert (mesh.devices.size, first, width) == (2, 2 * pid, 4)
    ordered, counts, topk = multihost_capped_sweep(driver, K=32)
    # the single-process reference, on one device
    ref = syn.build_driver(10, 200, seed=0, device="cpu").driver
    ref.set_mesh(False)
    _r, ref_ordered, _m, ref_counts, ref_topk = ref._audit_sweep(32)
    assert [o[:2] for o in ordered] == [o[:2] for o in ref_ordered]
    assert counts.dtype == ref_counts.dtype and topk.shape == ref_topk.shape
    assert (counts == ref_counts).all(), "multi-process counts diverge"
    assert (topk == ref_topk).all(), "multi-process first-K diverges"
    assert counts.sum() > 0
    refd = syn.build_referential_driver(3, 30, seed=0, device="cpu").driver
    try:
        multihost_capped_sweep(refd, K=32)
        raise AssertionError("a referential corpus was swept")
    except NotImplementedError:
        pass
    print(f"proc {pid}: multi-process sweep parity ok "
          f"({int(counts.sum())} candidates)", flush=True)
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sweep_parity():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        env = dict(os.environ, GK_REPO=repo, GK_COORD=coord,
                   GK_PROC=str(pid), GK_VIRTUAL_DEVICES="2")
        env.pop("GK_MESH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"multi-process worker hung:\n{out[-3000:]}")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "multi-process sweep parity ok" in out, out[-2000:]
