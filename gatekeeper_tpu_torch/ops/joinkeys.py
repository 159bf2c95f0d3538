"""The provider key table of one join plan: (uk, uc) int32, each [R*S].

uk holds the distinct key ids of the rows that take part in the plan's
aggregate (valid, of the remote kind, in its scope), ascending, then
KEY_INVALID; uc the number of distinct rows providing each key, then 0.
A row holding a key in two slots counts once.  This is
gatekeeper_tpu/ops/joinkernel.py ``provider_key_table`` on one device.

``join_keys`` launches the hand-written CUDA kernel K7
(kernels/joinkeys.cu) on CUDA tensors and runs ``join_keys_plain`` on
CPU ones.  The kernel counts into a [vocab] array, so ``vocab`` must
exceed every key id: the interner's size when the columns were packed.

``merge_key_tables`` is the cross-shard merge of a mesh sweep: the tables
of every shard's row slab, concatenated on one device, become the table of
the whole row axis (the all_gather and second ``compact_key_table`` of
gatekeeper_tpu/ops/joinkernel.py provider_key_table, :262-267).  On CUDA
tensors it launches K7's second launcher, counted as ``joinkeys_merge``;
on CPU ones its plain version is ``compact_key_table`` weighted by the
shards' counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import device as _dev
from .joinkernel import compact_key_table, key_table, participation


def join_keys_plain(valid, kind, ns_empty, sid, mask: Optional[torch.Tensor],
                    kind_id: int, namespaced: bool, vocab: int):
    """The sort and segment-reduce of the JAX package, in torch (``vocab``
    is not needed)."""
    part = participation(valid, kind, ns_empty, kind_id, namespaced)
    return key_table(part, sid, mask, torch)


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
        return uk, uc
    counts = torch.empty(max(vocab, 1), dtype=torch.int32, device=dev)
    _dev.launch(
        "joinkeys", dev, _dev.ptr(valid), _dev.ptr(kind),
        _dev.ptr(ns_empty), int(kind_id), int(namespaced), _dev.ptr(sid),
        0 if mask is None else _dev.ptr(mask), R, S, int(vocab),
        _dev.ptr(counts), _dev.ptr(uk), _dev.ptr(uc), _dev.stream(sid),
    )
    return uk, uc


def join_keys(valid, kind, ns_empty, sid, mask: Optional[torch.Tensor],
              kind_id: int, namespaced: bool, vocab: int):
    """K7 on CUDA tensors, the plain version on CPU ones."""
    if sid.device.type == "cpu":
        return join_keys_plain(valid, kind, ns_empty, sid, mask, kind_id,
                               namespaced, vocab)
    return join_keys_cuda(valid, kind, ns_empty, sid, mask, kind_id,
                          namespaced, vocab)


def merge_key_tables_plain(uk, uc, vocab: int):
    """The weighted group-by of the JAX package, in torch (``vocab`` is
    not needed)."""
    return compact_key_table(uk, uc, torch)


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
        return out_uk, out_uc
    counts = torch.empty(max(vocab, 1), dtype=torch.int32, device=dev)
    _dev.launch(
        "joinkeys_merge", dev, _dev.ptr(uk), _dev.ptr(uc), N, int(vocab),
        _dev.ptr(counts), _dev.ptr(out_uk), _dev.ptr(out_uc),
        _dev.stream(uk),
    )
    return out_uk, out_uc


def merge_key_tables(uk, uc, vocab: int):
    """K7's merge on CUDA tensors, the plain version on CPU ones."""
    if uk.device.type == "cpu":
        return merge_key_tables_plain(uk, uc, vocab)
    return merge_key_tables_cuda(uk, uc, vocab)
