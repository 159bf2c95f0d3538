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
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import device as _dev
from .joinkernel import key_table, participation


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
        "joinkeys", _dev.ptr(valid), _dev.ptr(kind), _dev.ptr(ns_empty),
        int(kind_id), int(namespaced), _dev.ptr(sid),
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
