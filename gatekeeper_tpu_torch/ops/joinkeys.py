"""The provider key table of one join plan: (uk, uc) int32, each [R*S],
and its dense counts, int32 [max(vocab, 1)].

uk holds the distinct key ids of the rows that take part in the plan's
aggregate (valid, of the remote kind, in its scope), ascending, then
KEY_INVALID; uc the number of distinct rows providing each key, then 0.
A row holding a key in two slots counts once.  This is
gatekeeper_tpu/ops/joinkernel.py ``provider_key_table`` on one device.
``dense[k]`` is k's count (0 for a key no row provides): K8 reads it in
place of searching (uk, uc) (ops/joinlookup.py).

``join_keys`` launches the hand-written CUDA kernel K7
(kernels/joinkeys.cu) on CUDA tensors and runs ``join_keys_plain`` on
CPU ones.  The kernel counts into the [vocab] dense array, so ``vocab``
must exceed every key id: the interner's size when the columns were
packed.

``merge_key_tables`` is the cross-shard merge of a mesh sweep: the tables
of every shard's row slab, concatenated on one device, become the table of
the whole row axis (the all_gather and second ``compact_key_table`` of
gatekeeper_tpu/ops/joinkernel.py provider_key_table, :262-267).  On CUDA
tensors it launches K7's second launcher, counted as ``joinkeys_merge``;
on CPU ones its plain version is ``compact_key_table`` weighted by the
shards' counts.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import device as _dev
from .joinkernel import (
    compact_key_table,
    dense_counts,
    key_table,
    participation,
)

#: the most blocks a K7 launch takes, the length of its block-total scratch
#: (the kernel's grid is the card's co-resident blocks, capped at this)
GRID_SLOTS = 1024


def grid_size(device, merge: bool = False) -> int:
    """The grid of K7's launches (``merge`` its merge's) on a CUDA
    ``device``: the blocks resident at once on every SM, at most
    GRID_SLOTS."""
    lib = _dev.kernels()["joinkeys"]
    fn = lib.gk_joinkeys_grid
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        grid = fn(int(merge), GRID_SLOTS)
    if grid <= 0:
        msg = lib.gk_error_string(-grid).decode()
        raise RuntimeError(f"joinkeys grid: {msg} ({-grid})")
    return grid


def block_size() -> int:
    """The threads of a K7 block, the ids of one pass over its chunk."""
    fn = _dev.kernels()["joinkeys"].gk_joinkeys_threads
    fn.argtypes = []
    fn.restype = ctypes.c_int
    return fn()


def _scratch(vocab: int, dev):
    """The dense counts [max(vocab, 1)] and the block totals [GRID_SLOTS],
    one allocation."""
    n = max(vocab, 1)
    buf = torch.empty(n + GRID_SLOTS, dtype=torch.int32, device=dev)
    return buf[:n], buf[n:]


def join_keys_plain(valid, kind, ns_empty, sid, mask: Optional[torch.Tensor],
                    kind_id: int, namespaced: bool, vocab: int):
    """The sort and segment-reduce of the JAX package, in torch, and the
    table's dense counts."""
    part = participation(valid, kind, ns_empty, kind_id, namespaced)
    uk, uc = key_table(part, sid, mask, torch)
    return uk, uc, dense_counts(uk, uc, vocab)


def join_keys_cuda(valid, kind, ns_empty, sid, mask: Optional[torch.Tensor],
                   kind_id: int, namespaced: bool, vocab: int):
    """K7."""
    dev = sid.device
    R = valid.shape[0]
    _dev.check(valid, "valid", torch.bool, 1, dev)
    _dev.check(kind, "kind", torch.int32, 1, dev)
    _dev.check(ns_empty, "ns_empty", torch.bool, 1, dev)
    _dev.check(sid, "sid", torch.int32, 1 if mask is None else 2, dev)
    if mask is not None:
        _dev.check(mask, "mask", torch.bool, 2, dev)
        if mask.shape != sid.shape:
            raise ValueError(f"mask {tuple(mask.shape)} != sid "
                             f"{tuple(sid.shape)}")
    if kind.shape[0] != R or ns_empty.shape[0] != R or sid.shape[0] != R:
        raise ValueError("valid, kind, ns_empty and sid differ in rows")
    if vocab < 0:
        raise ValueError(f"vocab {vocab} < 0")
    S = 1 if mask is None else sid.shape[1]
    uk = torch.empty(R * S, dtype=torch.int32, device=dev)
    uc = torch.empty(R * S, dtype=torch.int32, device=dev)
    if R * S == 0:
        return uk, uc, torch.zeros(max(vocab, 1), dtype=torch.int32,
                                   device=dev)
    dense, totals = _scratch(vocab, dev)
    _dev.launch(
        "joinkeys", dev, _dev.ptr(valid), _dev.ptr(kind),
        _dev.ptr(ns_empty), int(kind_id), int(namespaced), _dev.ptr(sid),
        0 if mask is None else _dev.ptr(mask), R, S, int(vocab),
        _dev.ptr(dense), _dev.ptr(totals), GRID_SLOTS, _dev.ptr(uk),
        _dev.ptr(uc), _dev.stream(sid),
    )
    return uk, uc, dense


def join_keys(valid, kind, ns_empty, sid, mask: Optional[torch.Tensor],
              kind_id: int, namespaced: bool, vocab: int):
    """K7 on CUDA tensors, the plain version on CPU ones."""
    if sid.device.type == "cpu":
        return join_keys_plain(valid, kind, ns_empty, sid, mask, kind_id,
                               namespaced, vocab)
    return join_keys_cuda(valid, kind, ns_empty, sid, mask, kind_id,
                          namespaced, vocab)


def merge_key_tables_plain(uk, uc, vocab: int):
    """The weighted group-by of the JAX package, in torch, and the merged
    table's dense counts."""
    out_uk, out_uc = compact_key_table(uk, uc, torch)
    return out_uk, out_uc, dense_counts(out_uk, out_uc, vocab)


def merge_key_tables_cuda(uk, uc, vocab: int):
    """K7's merge.  Every valid key of ``uk`` must have a count of at
    least 1 in ``uc``, as every shard table's has: a key whose counts sum
    to 0 is dropped, where the plain version keeps it with count 0."""
    dev = uk.device
    _dev.check(uk, "uk", torch.int32, 1, dev)
    _dev.check(uc, "uc", torch.int32, 1, dev)
    if uc.shape != uk.shape:
        raise ValueError(f"uc {tuple(uc.shape)} != uk {tuple(uk.shape)}")
    if vocab < 0:
        raise ValueError(f"vocab {vocab} < 0")
    N = uk.shape[0]
    out_uk = torch.empty(N, dtype=torch.int32, device=dev)
    out_uc = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return out_uk, out_uc, torch.zeros(max(vocab, 1), dtype=torch.int32,
                                           device=dev)
    dense, totals = _scratch(vocab, dev)
    _dev.launch(
        "joinkeys_merge", dev, _dev.ptr(uk), _dev.ptr(uc), N, int(vocab),
        _dev.ptr(dense), _dev.ptr(totals), GRID_SLOTS, _dev.ptr(out_uk),
        _dev.ptr(out_uc), _dev.stream(uk),
    )
    return out_uk, out_uc, dense


def merge_key_tables(uk, uc, vocab: int):
    """K7's merge on CUDA tensors, the plain version on CPU ones."""
    if uk.device.type == "cpu":
        return merge_key_tables_plain(uk, uc, vocab)
    return merge_key_tables_cuda(uk, uc, vocab)
