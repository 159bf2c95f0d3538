"""The join lookup: int32 counts in the shape of the query key ids ``q``.

Each count is ``uc[i]`` where ``uk[i] == q`` (and ``q >= 0``), else 0;
with a ``scope`` (JoinCmp.exclude_self) it is then less 1 where the row
itself takes part in the aggregate.  ``q`` is a key column, [R] or
[R, S]; ``scope`` is ``(valid, kind, ns_empty, kind_id, namespaced)``,
the rows' review fields and the plan's remote kind and scope.  This is
gatekeeper_tpu/ops/joinkernel.py ``lookup_counts`` with the
self-exclusion of gatekeeper_tpu/ops/vexpr.py ``_eval_joincmp``.

``join_lookup`` launches the hand-written CUDA kernel K8
(kernels/joinlookup.cu) on CUDA tensors and runs ``join_lookup_plain`` on
CPU ones.  ``uk`` must be ascending: K7's table or the host join index's.
Given ``dense``, K7's dense counts of the same table (a full sweep's), K8
reads each count there in place of searching ``uk`` (its dense mode); the
host index's tables come without it (table mode).  Both give the same
counts; the plain version searches ``uk`` either way.
"""

from __future__ import annotations

import torch

from .. import device as _dev
from .joinkernel import lookup_counts, participation


def join_lookup_plain(uk, uc, q, scope=None, dense=None):
    """``lookup_counts`` and the self-exclusion; ``dense`` is not read."""
    counts = lookup_counts(uk, uc, q, torch)
    if scope is None:
        return counts
    part = participation(*scope).to(torch.int32)
    if q.dim() == 2:
        part = part[:, None]
    return counts - part


def join_lookup_cuda(uk, uc, q, scope=None, dense=None):
    """K8: dense mode with ``dense``, table mode without."""
    dev = q.device
    _dev.check(uk, "uk", torch.int32, 1, dev)
    _dev.check(uc, "uc", torch.int32, 1, dev)
    if uc.shape != uk.shape:
        raise ValueError(f"uc {tuple(uc.shape)} != uk {tuple(uk.shape)}")
    if q.dim() not in (1, 2):
        raise ValueError(f"q: {q.dim()}-d, expected 1-d or 2-d")
    _dev.check(q, "q", torch.int32, q.dim(), dev)
    R = q.shape[0]
    S = q.shape[1] if q.dim() == 2 else 1
    if dense is None:
        mode, dense_ptr, V = 0, 0, 0
    else:
        _dev.check(dense, "dense", torch.int32, 1, dev)
        if dense.shape[0] == 0:
            raise ValueError("dense: empty")
        mode, dense_ptr, V = 1, _dev.ptr(dense), dense.shape[0]
    out = torch.empty(q.shape, dtype=torch.int32, device=dev)
    if R * S == 0:
        return out
    if scope is None:
        rows, kind_id, code = (0, 0, 0), 0, -1
    else:
        valid, kind, ns_empty, kind_id, namespaced = scope
        _dev.check(valid, "valid", torch.bool, 1, dev)
        _dev.check(kind, "kind", torch.int32, 1, dev)
        _dev.check(ns_empty, "ns_empty", torch.bool, 1, dev)
        if not valid.shape[0] == kind.shape[0] == ns_empty.shape[0] == R:
            raise ValueError("the scope's rows differ from q's")
        rows = tuple(_dev.ptr(t) for t in (valid, kind, ns_empty))
        code = int(bool(namespaced))
    _dev.launch(
        "joinlookup", dev, _dev.ptr(uk), _dev.ptr(uc), uk.shape[0],
        dense_ptr, V, mode, _dev.ptr(q), R, S, *rows, int(kind_id), code,
        _dev.ptr(out), _dev.stream(q),
    )
    return out


def join_lookup(uk, uc, q, scope=None, dense=None):
    """K8 on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return join_lookup_plain(uk, uc, q, scope, dense)
    return join_lookup_cuda(uk, uc, q, scope, dense)
