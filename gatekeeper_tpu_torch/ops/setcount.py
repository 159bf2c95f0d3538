"""Set-count comparison: count(left - right) <op> n, as bool[C, R].

One side is a constraint-parameter id set (``cids`` [C, P] with its
element mask ``cmask``), the other a review key set (``kids`` [R, K],
``pad`` marking empty slots).  ``orient`` 0 counts parameter elements
missing from the key set; 1 counts keys missing from the parameters.
``op`` codes: 0 ``>``, 1 ``>=``, 2 ``<``, 3 ``<=``, 4 ``==``, 5 ``!=``.

``setcount`` launches the hand-written CUDA kernel K3
(kernels/setcount.cu) on CUDA tensors and runs ``setcount_plain`` on CPU
tensors.
"""

from __future__ import annotations

import torch

from .. import device as _dev

_COMPARE = (
    lambda c, n: c > n, lambda c, n: c >= n, lambda c, n: c < n,
    lambda c, n: c <= n, lambda c, n: c == n, lambda c, n: c != n,
)


def setcount_plain(cids, cmask, kids, orient: int, op: int, n: int,
                   pad: int):
    """The parameter and key widths are unrolled so no transient exceeds
    [C, R]."""
    C, P = cids.shape
    R, K = kids.shape
    kmask = kids != pad
    cnt = torch.zeros((C, R), dtype=torch.int32, device=kids.device)
    if orient == 0:
        for p in range(P):
            cid = cids[:, p][:, None]  # [C, 1]
            inr = torch.zeros((C, R), dtype=torch.bool, device=kids.device)
            for k in range(K):
                inr |= (cid == kids[None, :, k]) & kmask[None, :, k]
            cnt += cmask[:, p][:, None] & ~inr
    elif orient == 1:
        for k in range(K):
            kid = kids[None, :, k]  # [1, R]
            inr = torch.zeros((C, R), dtype=torch.bool, device=kids.device)
            for p in range(P):
                inr |= (kid == cids[:, p][:, None]) & cmask[:, p][:, None]
            cnt += kmask[None, :, k] & ~inr
    else:
        raise ValueError(f"orient must be 0 or 1, got {orient}")
    return _COMPARE[op](cnt, n)


def setcount_cuda(cids, cmask, kids, orient: int, op: int, n: int,
                  pad: int):
    dev = kids.device
    _dev.check(cids, "cids", torch.int32, 2, dev)
    _dev.check(cmask, "cmask", torch.bool, 2, dev)
    _dev.check(kids, "kids", torch.int32, 2, dev)
    if cmask.shape != cids.shape:
        raise ValueError("cmask must match cids")
    if orient not in (0, 1) or not 0 <= op < len(_COMPARE):
        raise ValueError(f"bad orient {orient} or op {op}")
    C, P = cids.shape
    R, K = kids.shape
    out = torch.empty((C, R), dtype=torch.bool, device=dev)
    if C == 0 or R == 0:
        return out
    _dev.launch(
        "setcount", dev, _dev.ptr(cids), _dev.ptr(cmask), C, P, _dev.ptr(kids),
        R, K, pad, orient, op, n, _dev.ptr(out), _dev.stream(out),
    )
    return out


def setcount(cids, cmask, kids, orient: int, op: int, n: int, pad: int):
    """K3 on CUDA tensors, the plain version on CPU tensors."""
    if kids.device.type == "cpu":
        return setcount_plain(cids, cmask, kids, orient, op, n, pad)
    return setcount_cuda(cids, cmask, kids, orient, op, n, pad)
