"""String-predicate lookup of a review-side operand: bool[C, R(, S)].

    out[c, r(, s)] = negate XOR (tcode == STRING and sid >= 0 and
                                 tableT[clip(sid), idx[c]] != 0)

``tableT`` is a group's host-precomputed predicate table transposed to
[vocab, U]; ``idx`` picks each constraint's column.  ``strpred`` launches
the hand-written CUDA kernel K2 (kernels/strpred.cu) on CUDA tensors and
runs ``strpred_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import device as _dev
from .columns import T_STR


def _check_shapes(tableT, idx, tcode, sid):
    if sid.dim() < 2 or sid.shape[0] != 1 or tcode.shape != sid.shape:
        raise ValueError(
            f"review-side operand must be [1, R(, S)] with matching tcode; "
            f"got sid {tuple(sid.shape)}, tcode {tuple(tcode.shape)}"
        )
    if tableT.dim() != 2 or idx.dim() != 1:
        raise ValueError("tableT must be [vocab, U] and idx [C]")


def strpred_plain(tableT, idx, tcode, sid, negate: bool = False):
    _check_shapes(tableT, idx, tcode, sid)
    C = idx.shape[0]
    t = tcode.reshape(-1)
    s = sid.reshape(-1)
    rows = tableT[s.clamp(0, tableT.shape[0] - 1).long()]  # [N, U]
    hit = rows[:, idx.long()].T != 0  # [C, N]
    res = (t == T_STR) & (s >= 0) & hit
    if negate:
        res = ~res
    return res.reshape(C, *sid.shape[1:])


def strpred_cuda(tableT, idx, tcode, sid, negate: bool = False):
    _check_shapes(tableT, idx, tcode, sid)
    dev = sid.device
    _dev.check(tableT, "tableT", torch.uint8, 2, dev)
    _dev.check(idx, "idx", torch.int32, 1, dev)
    _dev.check(tcode, "tcode", torch.int8, sid.dim(), dev)
    _dev.check(sid, "sid", torch.int32, sid.dim(), dev)
    C = idx.shape[0]
    V, U = tableT.shape
    N = sid.numel()
    out = torch.empty((C, *sid.shape[1:]), dtype=torch.bool, device=dev)
    if C == 0 or N == 0:
        return out
    if V == 0 or U == 0:
        raise ValueError("empty predicate table")
    _dev.launch(
        "strpred", dev, _dev.ptr(tableT), V, U, _dev.ptr(idx), C,
        _dev.ptr(tcode), _dev.ptr(sid), N, int(bool(negate)), _dev.ptr(out),
        _dev.stream(out),
    )
    return out


def strpred(tableT, idx, tcode, sid, negate: bool = False):
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if sid.device.type == "cpu":
        return strpred_plain(tableT, idx, tcode, sid, negate)
    return strpred_cuda(tableT, idx, tcode, sid, negate)
