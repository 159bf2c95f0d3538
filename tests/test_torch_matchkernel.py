"""The port's match kernel (the plain PyTorch version the CPU runs) bit-equal
to the JAX match_kernel.  Each package packs the same review and constraint
dicts with its own pack_reviews / pack_constraints; the dicts come from
gatekeeper_tpu_torch/util/matchcorpus.py, made from a seed to reach every
branch of the match logic.  ``read_records`` reads the match from
constraint_records' packed record as kernel K1 reads it (each padded list
up to its live length, a selector with no live entry skipped whole); it is
held to both on matchcorpus and on the synthetic corpus.  Tolerance 0."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from gatekeeper_tpu.ops import matchkernel as jmk
from gatekeeper_tpu.ops import pack as jpack
from gatekeeper_tpu.ops.interning import Interner as JInterner
from gatekeeper_tpu_torch.convert import state_from_numpy
from gatekeeper_tpu_torch.ops import matchkernel as tmk
from gatekeeper_tpu_torch.ops import pack as tpack
from gatekeeper_tpu_torch.ops.interning import Interner as TInterner
from gatekeeper_tpu_torch.util import synthetic as tsyn
from gatekeeper_tpu_torch.util.matchcorpus import (
    NAMESPACES,
    make_corpus,
    make_review,
)


def _both(constraints, reviews):
    cached = NAMESPACES.get
    j_int, t_int = JInterner(), TInterner()
    j_rv = jpack.pack_reviews(reviews, j_int, cached).arrays
    j_cs = jpack.pack_constraints(constraints, j_int).arrays
    t_rv = tpack.pack_reviews(reviews, t_int, cached).arrays
    t_cs = tpack.pack_constraints(constraints, t_int).arrays
    jm, ja = jmk.match_kernel(
        {k: jnp.asarray(v) for k, v in j_rv.items()},
        {k: jnp.asarray(v) for k, v in j_cs.items()},
    )
    tm, ta = tmk.match_kernel(
        state_from_numpy(t_rv, "cpu"), state_from_numpy(t_cs, "cpu")
    )
    return (np.asarray(jm), np.asarray(ja)), (tm.numpy(), ta.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_match_kernel_bit_equal(seed):
    constraints, reviews = make_corpus(seed, 24, 40)  # + 2 pad rows
    (jm, ja), (tm, ta) = _both(constraints, reviews)
    assert tm.dtype == np.bool_ and tm.shape == jm.shape
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    assert not tm[len(constraints) - 2:].any()


def test_the_seeded_cases_reach_every_branch():
    """The random corpus is only a test if it makes both outcomes of the
    interesting branches: matches and misses, and autoreject cells."""
    constraints, reviews = make_corpus(0, 24, 40)
    (_jm, _ja), (tm, ta) = _both(constraints, reviews)
    assert tm.any() and not tm.all()
    assert ta.any()
    modes = tpack.pack_reviews(reviews, TInterner(), NAMESPACES.get)
    assert set(modes.arrays["ns_mode"][:40].tolist()) == {0, 1, 2, 3}


def test_no_selector_constraints_match_like_the_reference():
    """The JAX host path short-cuts constraints without selectors; the
    port evaluates every selector, and must agree."""
    constraints = [
        {"kind": "K", "metadata": {"name": "plain"}, "spec": {}},
        {"kind": "K", "metadata": {"name": "pods"}, "spec": {"match": {
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}},
    ]
    rng = random.Random(9)
    reviews = [make_review(rng, i) for i in range(16)]
    (jm, ja), (tm, ta) = _both(constraints, reviews)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)


PAD, WILD, UNDEF = -2, -1, -4


def _selector(lab, rec, sel, n):
    """matches_label_selector over one review's [L, 2] label slots, from
    the record: sel = (ml, Lc, op, key, vals, nvals, E, V) offsets and
    widths, n = its three live lengths."""
    ml, _lc, op, key, vals, nvals, _e, width = sel
    keys, values = lab[:, 0], lab[:, 1]
    real = keys != PAD
    for i in range(n[0]):
        k, v = rec[ml + 2 * i], rec[ml + 2 * i + 1]
        if k != PAD and not (real & (keys == k) & (values == v)).any():
            return False
    for e in range(n[1]):
        o = rec[op + e]
        if o == -1:
            continue
        k = rec[key + e]
        has = bool((real & (keys == k)).any())
        val_in = any((real & (keys == k)
                      & (values == rec[vals + e * width + v])).any()
                     for v in range(n[2]))
        nv = rec[nvals + e] > 0
        violated = {0: not has or (nv and not val_in),
                    1: has and nv and val_in, 2: not has,
                    3: has}.get(int(o), False)
        if violated:
            return False
    return True


def read_records(rv, crec, layout):
    """-> (match, autoreject) numpy bool [C, R], read cell by cell from
    constraint_records' [C, W] record and its 29-int layout, as K1 reads
    them."""
    crec = crec.numpy()
    rv = {k: v.numpy() for k, v in rv.items()}
    (_w, kp, _kp_w, ns_off, _n, ex_off, _x, has_ns, has_ex, scope,
     has_nssel, valid) = layout[:12]
    ls, nssel, live_off = layout[12:20], layout[20:28], layout[28]
    C, R = crec.shape[0], len(rv["valid"])
    match = np.zeros((C, R), bool)
    auto = np.zeros((C, R), bool)
    for c in range(C):
        rec = crec[c]
        live = rec[live_off:live_off + 9]
        ls_live, nssel_live = live[3] or live[4], live[6] or live[7]
        for r in range(R):
            ok = bool(rv["valid"][r] and rec[valid])
            auto[c, r] = bool(rec[has_nssel] and rv["autoreject"][r] and ok)
            g, kd, ns = rv["group"][r], rv["kind"][r], rv["ns_name"][r]
            alw = rv["always"][r]
            if ok:
                ok = any(rec[kp + 2 * p] != PAD
                         and rec[kp + 2 * p] in (WILD, g)
                         and rec[kp + 2 * p + 1] in (WILD, kd)
                         for p in range(live[0]))
            ids = list(rec[ns_off:ns_off + live[1]])
            xs = list(rec[ex_off:ex_off + live[2]])
            if ok and rec[has_ns] and not alw:
                ok = ns != UNDEF and ns in ids and ns != PAD
            if ok and rec[has_ex] and not alw:
                ok = ns != UNDEF and not (ns in xs and ns != PAD)
            if ok:
                sc = rec[scope]
                ok = (not rv["ns_empty"][r] if sc == 2 else
                      bool(rv["ns_empty"][r]) if sc == 3 else sc in (0, 1))

            def any_ls(sel, n):
                obj, old = rv["obj_labels"][r], rv["old_labels"][r]
                oe, de = rv["obj_empty"][r], rv["old_empty"][r]
                if oe and de:
                    return _selector(obj[:0], rec, sel, n)
                if de:
                    return _selector(obj, rec, sel, n)
                if oe:
                    return _selector(old, rec, sel, n)
                return _selector(obj, rec, sel, n) or \
                    _selector(old, rec, sel, n)

            if ok and ls_live:
                ok = any_ls(ls, live[3:6])
            if ok and rec[has_nssel]:
                mode = rv["ns_mode"][r]
                if mode == 1:
                    ok = not nssel_live or _selector(
                        rv["ns_labels"][r], rec, nssel, live[6:9])
                elif mode == 3:
                    ok = not nssel_live or any_ls(nssel, live[6:9])
                else:
                    ok = mode == 0
            match[c, r] = ok
    return match, auto


def _jax_match(rv, cs):
    jm, ja = jmk.match_kernel(
        {k: jnp.asarray(v.numpy()) for k, v in rv.items()},
        {k: jnp.asarray(v.numpy()) for k, v in cs.items()})
    return np.asarray(jm), np.asarray(ja)


def _hold_records(rv, cs):
    """-> the records' live lengths, after holding read_records to the
    plain version and the JAX match_kernel."""
    crec, layout = tmk.constraint_records(cs)
    assert len(layout) == 29 and crec.shape[1] == layout[0]
    got = read_records(rv, crec, layout)
    plain = tmk.match_kernel_plain(rv, cs)
    jax_out = _jax_match(rv, cs)
    for g, p, j in zip(got, plain, jax_out):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, j)
    return crec[:, layout[28]:layout[28] + 9]


@pytest.mark.parametrize("seed", range(3))
def test_k1_record_reader_on_the_selector_corpus(seed):
    constraints, reviews = make_corpus(seed, 24, 40)
    t_int = TInterner()
    rv = state_from_numpy(tpack.pack_reviews(reviews, t_int,
                                             NAMESPACES.get).arrays, "cpu")
    cs = state_from_numpy(tpack.pack_constraints(constraints, t_int).arrays,
                          "cpu")
    live = _hold_records(rv, cs)
    # live lengths cut the padded lists, and every selector kind is live
    widths = [cs["kind_pairs"].shape[1], cs["ns_ids"].shape[1],
              cs["ex_ids"].shape[1]]
    assert any((live[:, i] < w).any() for i, w in enumerate(widths))
    assert (live[:, 3:9] > 0).any(dim=0).all()
    assert (live[:, 3:9] == 0).all(dim=1).any()


def test_k1_record_reader_on_the_synthetic_corpus(monkeypatch):
    """The driver's own packed arrays (six families, no live selector),
    recorded at its match call."""
    from gatekeeper_tpu_torch.ops import driver as tdriver

    seen = []
    orig = tdriver.match_kernel

    def spy(rv, cs, records=None):
        seen.append((rv, cs))
        return orig(rv, cs, records)

    monkeypatch.setattr(tdriver, "match_kernel", spy)
    tsyn.build_driver(12, 120, device="cpu").audit_capped(20)
    (rv, cs), = seen
    live = _hold_records(rv, cs)
    assert (live[:, 3:9] == 0).all() and (live[:, 0] > 0).any()
