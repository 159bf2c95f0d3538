"""Vectorized constraint matching: match and autoreject, bool[C, R] each.

The selector logic of target_template_source.go:127-386 as boolean tensor
algebra over interned ids: kind selectors, namespaces/excludedNamespaces,
scope, labelSelector and namespaceSelector (matchLabels + matchExpressions),
plus the autoreject mask.

``match_kernel`` launches the hand-written CUDA kernel K1
(kernels/match.cu) on a CUDA tensor, and runs ``match_kernel_plain`` (the
same function in plain PyTorch) on a CPU tensor.  The plain version is
also what ``chip_smoke.py`` holds the kernel against on the card.

All arrays come from ops/pack.py (converted by convert.state_from_numpy);
dims: C constraints, R reviews, KP kind pairs, N/X namespace ids, L label
pairs, E match expressions, V values.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import device as _dev
from .pack import PAD, SCOPE_NONE, UNDEF, WILD

# ---- plain PyTorch version --------------------------------------------------


def _selector_match(lab_pairs, cs_ml, cs_op, cs_key, cs_vals, cs_nvals):
    """matches_label_selector over [R, L, 2] labels x [C, ...] selectors
    -> bool[C, R].  The small static widths are unrolled so no transient
    exceeds [C, R]."""
    lab_key = lab_pairs[:, :, 0]  # [R, L]
    lab_val = lab_pairs[:, :, 1]
    lab_ok = lab_key != PAD
    R, L = lab_key.shape
    C = cs_ml.shape[0]
    dev = lab_pairs.device

    def key_val_hit(k, v):  # k, v: [C, 1] -> any label slot matches both
        acc = torch.zeros((C, R), dtype=torch.bool, device=dev)
        for l in range(L):
            acc |= (
                (lab_key[None, :, l] == k) & (lab_val[None, :, l] == v)
                & lab_ok[None, :, l]
            )
        return acc

    def key_hit(k):
        acc = torch.zeros((C, R), dtype=torch.bool, device=dev)
        for l in range(L):
            acc |= (lab_key[None, :, l] == k) & lab_ok[None, :, l]
        return acc

    ml_ok = torch.ones((C, R), dtype=torch.bool, device=dev)
    for i in range(cs_ml.shape[1]):
        k = cs_ml[:, i, 0][:, None]
        v = cs_ml[:, i, 1][:, None]
        ml_ok &= key_val_hit(k, v) | (k == PAD)

    ex_ok = torch.ones((C, R), dtype=torch.bool, device=dev)
    for e in range(cs_op.shape[1]):
        op = cs_op[:, e][:, None]  # [C, 1]
        key = cs_key[:, e][:, None]
        has = key_hit(key)
        val_in = torch.zeros((C, R), dtype=torch.bool, device=dev)
        for v in range(cs_vals.shape[2]):
            val_in |= key_val_hit(key, cs_vals[:, e, v][:, None])
        nvals = cs_nvals[:, e][:, None] > 0
        violated = torch.where(
            op == 0, ~has | (nvals & ~val_in),  # In
            torch.where(
                op == 1, has & nvals & val_in,  # NotIn
                torch.where(
                    op == 2, ~has,  # Exists
                    (op == 3) & has,  # DoesNotExist / unknown
                ),
            ),
        )
        ex_ok &= ~(violated & (op != -1))
    return ml_ok & ex_ok


def _any_labelselector_match(rv, cs_ml, cs_op, cs_key, cs_vals, cs_nvals):
    """any_labelselector_match (target_template_source.go:233-278)."""
    args = (cs_ml, cs_op, cs_key, cs_vals, cs_nvals)
    sm_obj = _selector_match(rv["obj_labels"], *args)
    sm_old = _selector_match(rv["old_labels"], *args)
    empty = torch.full_like(rv["obj_labels"][:1], PAD)
    sm_empty = _selector_match(empty, *args)  # [C, 1]
    obj_e = rv["obj_empty"][None, :]
    old_e = rv["old_empty"][None, :]
    return torch.where(
        obj_e & old_e, sm_empty,
        torch.where(old_e, sm_obj, torch.where(obj_e, sm_old, sm_obj | sm_old)),
    )


def match_kernel_plain(rv: dict, cs: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (match bool[C, R], autoreject bool[C, R]) in plain PyTorch."""
    group = rv["group"][None, :]  # [1, R]
    kind = rv["kind"][None, :]
    C = cs["kind_pairs"].shape[0]
    R = group.shape[1]
    dev = group.device

    kinds_ok = torch.zeros((C, R), dtype=torch.bool, device=dev)
    for p in range(cs["kind_pairs"].shape[1]):
        kp_g = cs["kind_pairs"][:, p, 0][:, None]  # [C, 1]
        kp_k = cs["kind_pairs"][:, p, 1][:, None]
        kinds_ok |= (
            ((kp_g == WILD) | (kp_g == group))
            & ((kp_k == WILD) | (kp_k == kind))
            & (kp_g != PAD)
        )

    ns_name = rv["ns_name"][None, :]
    ns_def = ns_name != UNDEF
    always = rv["always"][None, :]

    def member(ids):
        acc = torch.zeros((C, R), dtype=torch.bool, device=dev)
        for i in range(ids.shape[1]):
            col = ids[:, i][:, None]
            acc |= (col == ns_name) & (col != PAD)
        return acc

    ns_ok = ~cs["has_ns"][:, None] | always | (ns_def & member(cs["ns_ids"]))
    ex_ok = ~cs["has_ex"][:, None] | always | (ns_def & ~member(cs["ex_ids"]))

    scope = cs["scope"][:, None]  # [C, 1]
    ns_empty = rv["ns_empty"][None, :]
    scope_ok = torch.where(
        (scope == SCOPE_NONE) | (scope == 1), True,
        torch.where(scope == 2, ~ns_empty, (scope == 3) & ns_empty),
    )

    ls_ok = _any_labelselector_match(
        rv, cs["ls_ml"], cs["ls_op"], cs["ls_key"], cs["ls_vals"],
        cs["ls_nvals"],
    )

    # namespaceSelector by mode: 0 always-T, 1 ns labels, 2 uncached-F, 3 is_ns
    sm_ns = _selector_match(
        rv["ns_labels"], cs["nssel_ml"], cs["ns_op"], cs["ns_key"],
        cs["ns_vals"], cs["ns_nvals"],
    )
    alm_ns = _any_labelselector_match(
        rv, cs["nssel_ml"], cs["ns_op"], cs["ns_key"], cs["ns_vals"],
        cs["ns_nvals"],
    )
    mode = rv["ns_mode"][None, :]
    nssel_result = torch.where(
        mode == 0, True,
        torch.where(mode == 1, sm_ns, (mode == 3) & alm_ns),
    )
    nssel_ok = ~cs["has_nssel"][:, None] | nssel_result

    valid = cs["valid"][:, None] & rv["valid"][None, :]
    match = kinds_ok & ns_ok & ex_ok & scope_ok & ls_ok & nssel_ok & valid
    autoreject = cs["has_nssel"][:, None] & rv["autoreject"][None, :] & valid
    return match, autoreject


# ---- K1: the CUDA kernel ------------------------------------------------------

# constraint-record fields, in the order of kernels/match.cu's Layout
_SCALARS = ("has_ns", "has_ex", "scope", "has_nssel", "valid")
_SELECTORS = (
    ("ls_ml", "ls_op", "ls_key", "ls_vals", "ls_nvals"),
    ("nssel_ml", "ns_op", "ns_key", "ns_vals", "ns_nvals"),
)


def _live_len(live: torch.Tensor) -> torch.Tensor:
    """bool [C, n, ...] -> int32 [C]: one past the last index along dim 1
    that holds a live entry anywhere, 0 for none (the packer's widths are
    at least 1)."""
    C, n = live.shape[:2]
    pos = torch.arange(1, n + 1, dtype=torch.int32, device=live.device)
    any_live = live.reshape(C, n, -1).any(dim=2)
    return (any_live.to(torch.int32) * pos).amax(dim=1).to(torch.int32)


def live_lengths(cs: dict) -> torch.Tensor:
    """int32 [C, 9]: each constraint's live entries of every padded list,
    one past the last live one: kind pairs, namespace ids, excluded ids,
    then for each selector its matchLabels pairs, expressions, and
    expression values (the longest over its expressions).  A PAD entry can
    never hit: a label's value is an interned id or NON_STRING, not PAD."""
    cols = [_live_len(cs["kind_pairs"][..., 0] != PAD),
            _live_len(cs["ns_ids"] != PAD), _live_len(cs["ex_ids"] != PAD)]
    for ml, op, _key, vals, _nvals in _SELECTORS:
        cols += [_live_len(cs[ml][..., 0] != PAD), _live_len(cs[op] != -1),
                 _live_len((cs[vals] != PAD).transpose(1, 2))]
    return torch.stack(cols, dim=1)


def constraint_records(cs: dict) -> Tuple[torch.Tensor, list]:
    """Pack the constraint side into one int32 record per constraint
    ([C, W]) plus the field offsets kernels/match.cu reads it by; the
    record ends with live_lengths(cs)."""
    C = cs["valid"].shape[0]
    parts = []
    off = 0

    def put(a) -> int:
        nonlocal off
        start = off
        flat = a.reshape(C, -1).to(torch.int32)
        parts.append(flat)
        off += flat.shape[1]
        return start

    layout = [0]  # W, filled in below
    layout += [put(cs["kind_pairs"]), cs["kind_pairs"].shape[1]]
    layout += [put(cs["ns_ids"]), cs["ns_ids"].shape[1]]
    layout += [put(cs["ex_ids"]), cs["ex_ids"].shape[1]]
    layout += [put(cs[name]) for name in _SCALARS]
    for ml, op, key, vals, nvals in _SELECTORS:
        layout += [
            put(cs[ml]), cs[ml].shape[1], put(cs[op]), put(cs[key]),
            put(cs[vals]), put(cs[nvals]), cs[op].shape[1],
            cs[vals].shape[2],
        ]
    layout.append(put(live_lengths(cs)))
    layout[0] = off
    return torch.cat(parts, dim=1).contiguous(), layout


_RV_IDS = ("group", "kind", "ns_name")
_RV_FLAGS = ("always", "ns_empty", "obj_empty", "old_empty", "autoreject",
             "valid")
_RV_LABELS = ("obj_labels", "old_labels", "ns_labels")


def match_kernel_cuda(rv: dict, cs: dict, records=None):
    """K1 on the card.  ``records`` is constraint_records(cs), which a
    caller may cache across calls with the constraint side."""
    dev = rv["valid"].device
    R = rv["valid"].shape[0]
    for name in _RV_IDS:
        _dev.check(rv[name], name, torch.int32, 1, dev)
    _dev.check(rv["ns_mode"], "ns_mode", torch.int8, 1, dev)
    for name in _RV_FLAGS:
        _dev.check(rv[name], name, torch.bool, 1, dev)
    for name in _RV_LABELS:
        _dev.check(rv[name], name, torch.int32, 3, dev)
    for name in (*_RV_IDS, "ns_mode", *_RV_FLAGS, *_RV_LABELS):
        if rv[name].shape[0] != R:
            raise ValueError(f"{name}: {rv[name].shape[0]} rows, expected {R}")
    crec, layout = records if records is not None else constraint_records(cs)
    _dev.check(crec, "constraint records", torch.int32, 2, dev)
    C = crec.shape[0]
    match = torch.empty((C, R), dtype=torch.bool, device=dev)
    autoreject = torch.empty((C, R), dtype=torch.bool, device=dev)
    if C == 0 or R == 0:
        return match, autoreject
    lay = (ctypes.c_int * len(layout))(*layout)
    _dev.launch(
        "match", dev, ctypes.addressof(lay), _dev.ptr(crec), C, R,
        *(_dev.ptr(rv[n]) for n in (*_RV_IDS, "ns_mode", *_RV_FLAGS,
                                    *_RV_LABELS)),
        *(rv[n].shape[1] for n in _RV_LABELS),
        _dev.ptr(match), _dev.ptr(autoreject), _dev.stream(match),
    )
    return match, autoreject


def match_kernel(rv: dict, cs: dict, records=None):
    """-> (match bool[C, R], autoreject bool[C, R]): K1 on a CUDA tensor,
    the plain version on a CPU tensor."""
    if rv["valid"].device.type == "cpu":
        return match_kernel_plain(rv, cs)
    return match_kernel_cuda(rv, cs, records)
