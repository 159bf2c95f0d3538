"""The join lookup: int32 counts in the shape of the query key ids ``q``.

Each count is ``uc[i]`` where ``uk[i] == q`` (and ``q >= 0``), else 0;
with a ``scope`` (JoinCmp.exclude_self) it is then less 1 where the row
itself takes part in the aggregate.  ``q`` is a key column, [R] or
[R, S]; ``scope`` is ``(valid, kind, ns_empty, kind_id, namespaced)``,
the rows' review fields and the plan's remote kind and scope.  This is
gatekeeper_tpu/ops/joinkernel.py ``lookup_counts`` with the
self-exclusion of gatekeeper_tpu/ops/vexpr.py ``_eval_joincmp``.

The hand-written CUDA kernel K8 (kernels/joinlookup.cu) has two modes.
Table mode searches ``uk``, which must be ascending (K7's table or the
host join index's): ``join_lookup_many`` runs every table-mode lookup of
one evaluation, each a ``(uk, uc, q, scope)``, in one launch (up to
MAX_LOOKUPS; an evaluation names a few), a warp's 32-ary search a
query.  Dense mode reads K7's dense counts of the same
table (``dense``, a full sweep's) in place of searching ``uk``:
``join_lookup`` with ``dense``; without it ``join_lookup`` is a table-mode
launch of one lookup.  Both modes give the same counts; the plain version
searches ``uk`` either way.  On CPU tensors the wrappers run
``join_lookup_plain``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import device as _dev
from .joinkernel import lookup_counts, participation

# kernels/joinlookup.cu's table launch: int64 words a lookup's descriptor,
# lookups a launch at most (its parameters hold their descriptors), warps
# a block, and blocks a lookup at most (its warps stride past them)
DESC_WORDS = 16
MAX_LOOKUPS = 64
WARPS = 8
MAX_BLOCKS = 4096


def join_lookup_plain(uk, uc, q, scope=None, dense=None):
    """``lookup_counts`` and the self-exclusion; ``dense`` is not read."""
    counts = lookup_counts(uk, uc, q, torch)
    if scope is None:
        return counts
    part = participation(*scope).to(torch.int32)
    if q.dim() == 2:
        part = part[:, None]
    return counts - part


def _check_lookup(uk, uc, q, scope, dev):
    """A lookup's tensors checked -> (R, S, the scope's row pointers,
    kind id, scope code: -1 none, 1 namespaced, 0 cluster)."""
    _dev.check(uk, "uk", torch.int32, 1, dev)
    _dev.check(uc, "uc", torch.int32, 1, dev)
    if uc.shape != uk.shape:
        raise ValueError(f"uc {tuple(uc.shape)} != uk {tuple(uk.shape)}")
    if q.dim() not in (1, 2):
        raise ValueError(f"q: {q.dim()}-d, expected 1-d or 2-d")
    _dev.check(q, "q", torch.int32, q.dim(), dev)
    R = q.shape[0]
    S = q.shape[1] if q.dim() == 2 else 1
    if scope is None:
        return R, S, (0, 0, 0), 0, -1
    valid, kind, ns_empty, kind_id, namespaced = scope
    _dev.check(valid, "valid", torch.bool, 1, dev)
    _dev.check(kind, "kind", torch.int32, 1, dev)
    _dev.check(ns_empty, "ns_empty", torch.bool, 1, dev)
    if not valid.shape[0] == kind.shape[0] == ns_empty.shape[0] == R:
        raise ValueError("the scope's rows differ from q's")
    rows = tuple(_dev.ptr(t) for t in (valid, kind, ns_empty))
    return R, S, rows, int(kind_id), int(bool(namespaced))


def table_launch(lookups, outs, dev) -> tuple:
    """The descriptors of K8's table launch for ``lookups`` (each
    ``(uk, uc, q, scope)``) writing ``outs``, checked -> (int64 [L *
    DESC_WORDS], blocks).  Lookup l's blocks follow the blocks of the
    lookups before it: ceil(R S / WARPS), a warp a query, at most
    MAX_BLOCKS; one of R S = 0 takes none."""
    desc = np.zeros((len(lookups), DESC_WORDS), np.int64)
    blocks = 0
    for d, (uk, uc, q, scope), out in zip(desc, lookups, outs):
        R, S, rows, kind_id, code = _check_lookup(uk, uc, q, scope, dev)
        n = min(-(-R * S // WARPS), MAX_BLOCKS)
        d[:14] = [_dev.ptr(uk), _dev.ptr(uc), uk.shape[0], _dev.ptr(q), R,
                  S, *rows, kind_id, code, _dev.ptr(out), blocks, n]
        blocks += n
    return desc.reshape(-1), blocks


def join_lookup_many_plain(lookups) -> List[torch.Tensor]:
    return [join_lookup_plain(uk, uc, q, scope)
            for uk, uc, q, scope in lookups]


def join_lookup_many_cuda(lookups) -> List[torch.Tensor]:
    """K8's table mode: every lookup in one launch (none where no lookup
    has a query), MAX_LOOKUPS a launch; the descriptors go into the
    launch's parameters, from host memory."""
    if not lookups:
        return []
    dev = lookups[0][2].device
    outs = [torch.empty(q.shape, dtype=torch.int32, device=dev)
            for _uk, _uc, q, _s in lookups]
    for at in range(0, len(lookups), MAX_LOOKUPS):
        part = lookups[at:at + MAX_LOOKUPS]
        desc, blocks = table_launch(part, outs[at:at + MAX_LOOKUPS], dev)
        if blocks:
            _dev.launch("joinlookup_table", dev, desc.ctypes.data, len(part),
                        blocks, _dev.stream(lookups[0][2]))
    return outs


def join_lookup_many(lookups) -> List[torch.Tensor]:
    """The counts of each ``(uk, uc, q, scope)`` of one evaluation: K8's
    table mode, one launch, on CUDA tensors; the plain version on CPU
    ones."""
    if lookups and lookups[0][2].device.type == "cpu":
        return join_lookup_many_plain(lookups)
    return join_lookup_many_cuda(lookups)


def join_lookup_cuda(uk, uc, q, scope=None, dense=None):
    """K8: dense mode with ``dense``; without it, table mode's launch of
    this one lookup."""
    if dense is None:
        return join_lookup_many_cuda([(uk, uc, q, scope)])[0]
    dev = q.device
    R, S, rows, kind_id, code = _check_lookup(uk, uc, q, scope, dev)
    _dev.check(dense, "dense", torch.int32, 1, dev)
    if dense.shape[0] == 0:
        raise ValueError("dense: empty")
    out = torch.empty(q.shape, dtype=torch.int32, device=dev)
    if R * S == 0:
        return out
    _dev.launch(
        "joinlookup", dev, _dev.ptr(dense), dense.shape[0], _dev.ptr(q), R,
        S, *rows, kind_id, code, _dev.ptr(out), _dev.stream(q),
    )
    return out


def join_lookup(uk, uc, q, scope=None, dense=None):
    """K8 on CUDA tensors, the plain version on CPU ones."""
    if q.device.type == "cpu":
        return join_lookup_plain(uk, uc, q, scope, dense)
    return join_lookup_cuda(uk, uc, q, scope, dense)
