"""Every kernel launch runs inside its tensors' device.

The C launchers start their kernels on the CUDA runtime's current device,
and a mesh shard's tensors may lie on another card than the current one.
So ``device.launch`` takes the device of the tensors it launches on and
calls the launcher inside ``torch.cuda.device`` of it, and every wrapper
hands it the device of its inputs.  Both are checked here on the CPU:
``launch`` with a stand-in library and device context, each of the
fourteen launchers' wrappers with ``launch`` recording what it was handed (the
wrappers' CUDA functions, called on CPU tensors, with the stream and the
pinned staging buffer stood in for)."""

import contextlib

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch import device as dev
from gatekeeper_tpu_torch.ops import delta, joinkeys, joinlookup
from gatekeeper_tpu_torch.ops import driver as driver_mod
from gatekeeper_tpu_torch.ops import matchkernel, packbits, program
from gatekeeper_tpu_torch.ops import reduction
from gatekeeper_tpu_torch.ops import scatter, setcount, strpred
from gatekeeper_tpu_torch.util import synthetic as syn

CPU = torch.device("cpu")


def test_launch_enters_the_device_it_is_given(monkeypatch):
    entered, current = [], [None]

    @contextlib.contextmanager
    def fake_device(d):
        entered.append(torch.device(d))
        before, current[0] = current[0], torch.device(d)
        yield
        current[0] = before

    class Lib:
        def __getattr__(self, fn_name):
            def launcher(*args):
                calls.append((fn_name, current[0], args))
                return 0
            return launcher

    calls = []
    libs = {name: Lib() for name in dev.KERNEL_NAMES}
    monkeypatch.setattr(dev, "kernels", lambda: libs)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    dev.reset_launches()
    target = torch.device("cuda", 3)
    for name, (_lib, fn_name, sig) in dev._SIGNATURES.items():
        dev.launch(name, target, *range(len(sig)))
        assert calls[-1][:2] == (fn_name, target), name
    assert entered == [target] * len(dev._SIGNATURES)
    assert current[0] is None  # left again after each call
    assert all(n == 1 for n in dev.launches.values())
    with pytest.raises(TypeError):
        dev.launch("reduction", target, 1, 2)
    dev.reset_launches()


def _i32(a):
    return torch.tensor(a, dtype=torch.int32)


def _sweep_inputs():
    """A tiny CPU sweep's match inputs and its bound K9 groups."""
    client = syn.build_driver(4, 12, device="cpu")
    d = client.driver
    client.audit_capped(5)
    side = d._constraint_side()
    rv, cols = d._audit_dev[1]
    placed = d._constraint_device(side)
    seen = []
    orig = driver_mod.program_eval
    driver_mod.program_eval = lambda mask, groups: seen.append(groups) or mask
    try:
        mask, _rej = d._eval(side, rv, cols, placed)
    finally:
        driver_mod.program_eval = orig
    return rv, placed[0], mask, seen[0]


def test_every_wrapper_hands_launch_its_inputs_device(monkeypatch):
    rv, cs, mask, groups = _sweep_inputs()
    got = []
    monkeypatch.setattr(dev, "launch",
                        lambda name, device, *args: got.append((name,
                                                                device)))
    monkeypatch.setattr(dev, "stream", lambda t: 0)
    monkeypatch.setattr(dev, "pinned_empty",
                        lambda n: torch.empty(n, dtype=torch.uint8))
    matchkernel.match_kernel_cuda(rv, cs, matchkernel.constraint_records(cs))
    program.program_eval_cuda(mask.clone(), groups)
    program.program_eval_cuda(mask.clone(), groups, pack=(
        ~mask, packbits.packed_empty(*mask.shape, CPU)))
    C, R = mask.shape
    program.program_eval_cuda(mask.clone(), groups, delta=(
        torch.zeros((C, R + 5), dtype=torch.bool), _i32(list(range(R))),
        torch.empty((C, 2 * R), dtype=torch.int8)))
    reduction.packed_reduction_cuda(mask, 8, row_offset=64)
    strpred.strpred_cuda(
        torch.tensor([[0, 1], [1, 0]], dtype=torch.uint8), _i32([0, 1]),
        torch.tensor([[5, 5]], dtype=torch.int8), _i32([[0, 1]]))
    setcount.setcount_cuda(_i32([[3, 4]]), torch.tensor([[True, True]]),
                           _i32([[3, -2], [7, 8]]), 0, 0, 0, -2)
    delta.delta_columns_cuda(mask, _i32([0, 2]),
                             torch.zeros((mask.shape[0], 2), dtype=bool))
    tree = {"a": torch.zeros((4, 2), dtype=torch.int32),
            "b": torch.zeros(4, dtype=torch.bool)}
    scatter.scatter_staged_cuda(scatter.stage_rows(
        tree, np.array([1, 3]),
        {"a": np.ones((2, 2), np.int32), "b": np.ones(2, bool)}))
    valid = torch.ones(3, dtype=torch.bool)
    kind = _i32([1, 1, 0])
    ns_empty = torch.zeros(3, dtype=torch.bool)
    uk, uc, dense = joinkeys.join_keys_cuda(
        valid, kind, ns_empty, _i32([2, 0, 1]), None, 1, True, 4)
    joinkeys.merge_key_tables_cuda(_i32([0, 2, 2]), _i32([1, 1, 2]), 4)
    joinlookup.join_lookup_cuda(_i32([0, 2]), _i32([1, 2]), _i32([2, 1, 0]),
                                (valid, kind, ns_empty, 1, True))
    joinlookup.join_lookup_cuda(uk, uc, _i32([2, 1, 0]),
                                (valid, kind, ns_empty, 1, True), dense=dense)
    packbits.pack_review_masks_cuda(mask, ~mask)
    assert {name for name, _d in got} == set(dev.LAUNCHERS)
    assert all(d == CPU for _n, d in got), got


def test_join_launchers_get_their_modes_and_scratch(monkeypatch):
    """K8's table launcher takes (descriptors in host memory, lookups,
    blocks), a descriptor a lookup (uk, uc, T, q, R, S, the scope's rows,
    kind id and code, out, first block, blocks), without ``dense``, at
    most MAX_LOOKUPS a launch; its dense launcher (dense, V, q, R, S, ...)
    with it; K7's two launchers get the dense counts and the block totals
    after them, and the totals' length."""
    import ctypes

    got, uploads = [], []

    def launch(name, device, *args):
        got.append((name, args))
        if name == "joinlookup_table":  # the descriptors, while they live
            words = ctypes.cast(args[0], ctypes.POINTER(ctypes.c_int64))
            uploads.append(np.ctypeslib.as_array(
                words, (args[1] * joinlookup.DESC_WORDS,)).copy())

    monkeypatch.setattr(dev, "launch", launch)
    monkeypatch.setattr(dev, "stream", lambda t: 0)
    uk, uc = _i32([0, 2, 2**31 - 1]), _i32([1, 2, 0])
    dense = _i32([1, 0, 2, 0])
    q = _i32([[2, 1], [0, 3], [-1, 5]])
    out = joinlookup.join_lookup_cuda(uk, uc, q)
    joinlookup.join_lookup_cuda(uk, uc, q, dense=dense)
    (n0, table), (n1, dense_mode) = got
    assert (n0, n1) == ("joinlookup_table", "joinlookup")
    assert len(table) == len(dev._SIGNATURES["joinlookup_table"][2])
    assert len(dense_mode) == len(dev._SIGNATURES["joinlookup"][2])
    [desc] = uploads
    assert table[1:3] == (1, 1)  # one lookup, its 6 queries one block
    assert desc.tolist() == [uk.data_ptr(), uc.data_ptr(), 3, q.data_ptr(),
                             3, 2, 0, 0, 0, 0, -1, out.data_ptr(), 0, 1, 0,
                             0]
    assert dense_mode[:5] == (dense.data_ptr(), 4, q.data_ptr(), 3, 2)
    # past MAX_LOOKUPS a launch: a launch each MAX_LOOKUPS, blocks from 0
    got.clear()
    uploads.clear()
    n = joinlookup.MAX_LOOKUPS + 3
    outs = joinlookup.join_lookup_many_cuda([(uk, uc, q, None)] * n)
    assert [(name, a[1:3]) for name, a in got] == [
        ("joinlookup_table", (joinlookup.MAX_LOOKUPS, n - 3)),
        ("joinlookup_table", (3, 3))]
    last = uploads[1].reshape(3, joinlookup.DESC_WORDS)
    assert last[:, 12].tolist() == [0, 1, 2]
    assert last[:, 11].tolist() == [o.data_ptr() for o in outs[-3:]]
    with pytest.raises(ValueError, match="dense"):
        joinlookup.join_lookup_cuda(uk, uc, q, dense=_i32([]))
    with pytest.raises(TypeError, match="dense"):
        joinlookup.join_lookup_cuda(uk, uc, q, dense=dense.long())
    got.clear()
    valid = torch.ones(3, dtype=torch.bool)
    kind = _i32([1, 1, 0])
    ns_empty = torch.zeros(3, dtype=torch.bool)
    _uk, _uc, kdense = joinkeys.join_keys_cuda(
        valid, kind, ns_empty, _i32([2, 0, 1]), None, 1, True, 6)
    _uk, _uc, mdense = joinkeys.merge_key_tables_cuda(
        _i32([0, 2, 2]), _i32([1, 1, 2]), 0)
    (name, kargs), (mname, margs) = got
    assert (name, mname) == ("joinkeys", "joinkeys_merge")
    assert len(kargs) == len(dev._SIGNATURES["joinkeys"][2])
    assert len(margs) == len(dev._SIGNATURES["joinkeys_merge"][2])
    assert kargs[10:13] == (kdense.data_ptr(), kdense.data_ptr() + 4 * 6,
                            joinkeys.GRID_SLOTS)
    assert kdense.shape == (6,) and mdense.shape == (1,)
    assert margs[4:7] == (mdense.data_ptr(), mdense.data_ptr() + 4,
                          joinkeys.GRID_SLOTS)
