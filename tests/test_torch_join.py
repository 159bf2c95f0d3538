"""The port's referential audit (gatekeeper_tpu_torch on the CPU: the join
key tables, the join lookup, join-mode sweeps, the join delta path and the
grouped render) against the JAX package and the InterpDriver oracle.

Inputs are made from seeds with numpy and handed to both packages.  Every
comparison is exact (tolerance 0): keys, counts and masks are integers or
bools, results are rendered strings.  The port compares counts in float64
and the JAX package in float32; counts are small integers, exact in both.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.client.drivers import InterpDriver
from gatekeeper_tpu.ops import joinkernel as jjk
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu.util import synthetic as jsyn
from gatekeeper_tpu_torch import device as tdev
from gatekeeper_tpu_torch.client.client import Client as TorchClient
from gatekeeper_tpu_torch.ops import joinkernel as tjk
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.ops.joinkeys import (
    join_keys,
    join_keys_plain,
    merge_key_tables,
    merge_key_tables_plain,
)
from gatekeeper_tpu_torch.ops.joinlookup import join_lookup, join_lookup_plain

CAP = 4096  # above every per-constraint count: totals exact everywhere
INVALID = int(tjk.KEY_INVALID)
sig = jsyn.audit_result_sig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(port, jax_out):
    """A torch tensor and a jnp / numpy array: same dtype width, values."""
    got, want = port.numpy(), np.asarray(jax_out)
    assert got.shape == want.shape
    assert got.dtype.itemsize == want.dtype.itemsize, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the plain key-table and lookup functions, against the JAX package's
# ---------------------------------------------------------------------------


def _keys(rng, n, vocab, p_invalid):
    k = rng.integers(0, vocab, n).astype(np.int32)
    k[rng.random(n) < p_invalid] = INVALID
    return k


@pytest.mark.parametrize("n,vocab,p_invalid", [
    (1, 4, 0.0), (7, 3, 0.3), (64, 10, 0.5), (300, 1000, 0.1),
    (50, 50, 1.0),  # every entry invalid: the empty table
])
def test_compact_key_table_bit_equal(n, vocab, p_invalid):
    rng = np.random.default_rng(n * 7 + vocab)
    keys = _keys(rng, n, vocab, p_invalid)
    for w in ((keys != INVALID).astype(np.int32),
              rng.integers(0, 9, n).astype(np.int32)):
        uk, uc = tjk.compact_key_table(_t(keys), _t(w), torch)
        juk, juc = jjk.compact_key_table(jnp.asarray(keys), jnp.asarray(w),
                                         jnp)
        _same(uk, juk)
        _same(uc, juc)
        nuk, nuc = tjk.compact_key_table(keys, w, np)
        np.testing.assert_array_equal(nuk, np.asarray(juk))
        np.testing.assert_array_equal(nuc, np.asarray(juc))


@pytest.mark.parametrize("R,S", [(5, 1), (40, 3), (9, 40)])
def test_row_distinct_slot_keys_bit_equal(R, S):
    rng = np.random.default_rng(R + S)
    sid = rng.integers(-5, 6, (R, S)).astype(np.int32)  # many duplicates
    mask = (rng.random((R, S)) < 0.8) & (sid >= 0)
    got = tjk.row_distinct_slot_keys(_t(sid), _t(mask), torch)
    _same(got, jjk.row_distinct_slot_keys(jnp.asarray(sid),
                                          jnp.asarray(mask), jnp))


def _plan(slot, scope):
    return jjk.JoinPlan(
        agg="dup", local_colkey=("joinkey", "k"), local_slot=slot,
        remote_scope=scope, remote_kind="Kind",
        remote_colkey=("joinkey", "k"), remote_slot=slot,
    )


def _rows(rng, R, S, vocab, slot):
    rv = {
        "valid": rng.random(R) < 0.9,
        "kind": rng.integers(0, 3, R).astype(np.int32),
        "ns_empty": rng.random(R) < 0.3,
    }
    shape = (R, S) if slot else (R,)
    sid = rng.integers(0, vocab, shape).astype(np.int32)
    odd = rng.random(shape)
    sid[odd < 0.05] = -1
    sid[(odd >= 0.05) & (odd < 0.08)] = tjk.UNKNOWN_KEY
    col = {"sid": sid}
    if slot:
        col["mask"] = rng.random(shape) < 0.85
    return rv, {("joinkey", "k"): col}


@pytest.mark.parametrize("slot", [False, True])
@pytest.mark.parametrize("scope", ["namespace", "cluster"])
def test_provider_key_table_bit_equal(slot, scope):
    rng = np.random.default_rng(3 + slot + 2 * (scope == "cluster"))
    R, S, vocab = 257, 4, 40
    rv, cols = _rows(rng, R, S, vocab, slot)
    plan = _plan(slot, scope)
    juk, juc = jjk.provider_key_table(
        plan, jnp.int32(1), {k: jnp.asarray(v) for k, v in rv.items()},
        {ck: {k: jnp.asarray(v) for k, v in c.items()}
         for ck, c in cols.items()}, jnp,
    )
    trv = {k: _t(v) for k, v in rv.items()}
    tcols = {ck: {k: _t(v) for k, v in c.items()} for ck, c in cols.items()}
    uk, uc = tjk.provider_key_table(plan, 1, trv, tcols, torch)
    _same(uk, juk)
    _same(uc, juc)
    col = tcols[("joinkey", "k")]
    kuk, kuc, kdense = join_keys_plain(
        trv["valid"], trv["kind"], trv["ns_empty"], col["sid"],
        col.get("mask"), 1, scope == "namespace", vocab)
    assert torch.equal(kuk, uk) and torch.equal(kuc, uc)
    assert int((uk != INVALID).sum()) > 0  # the table is not empty
    # under a mesh: the shards' slabs (their rows sum to R, so the merged
    # table has the single table's length), each table and the merge
    cuts = [0, 100, 101, 200, R]
    shards = [({k: v[a:b] for k, v in trv.items()},
               {ck: {k: v[a:b] for k, v in c.items()}
                for ck, c in tcols.items()}) for a, b in zip(cuts, cuts[1:])]
    muk, muc, mdense = tjk.provider_key_table(
        plan, 1, [r for r, _c in shards], [c for _r, c in shards], torch,
        axis_name="data", vocab=vocab)
    assert torch.equal(muk, uk) and torch.equal(muc, uc)
    assert torch.equal(mdense, kdense)
    with pytest.raises(ValueError, match="vocab"):
        tjk.provider_key_table(plan, 1, [trv], [tcols], torch,
                               axis_name="data")


@pytest.mark.parametrize("slot", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 8])
def test_weighted_merge_bit_equal_to_jax_compact_over_shard_tables(slot, W):
    """The cross-shard merge: the JAX package's per-shard provider tables,
    gathered and compacted with their counts as weights
    (gatekeeper_tpu/ops/joinkernel.py:262-267), against the port's merge
    of the same tables; and equal to the whole row axis's table."""
    rng = np.random.default_rng(11 * W + slot)
    R, S, vocab = 96, 3, 20  # few keys: many span shards
    rv, cols = _rows(rng, R, S, vocab, slot)
    plan = _plan(slot, "namespace")
    slab = -(-R // W)

    def jtable(a, b):
        return jjk.provider_key_table(
            plan, jnp.int32(1), {k: jnp.asarray(v[a:b])
                                 for k, v in rv.items()},
            {ck: {k: jnp.asarray(v[a:b]) for k, v in c.items()}
             for ck, c in cols.items()}, jnp)

    tabs = [jtable(s * slab, min(R, (s + 1) * slab)) for s in range(W)]
    ku = np.concatenate([np.asarray(t[0]) for t in tabs])
    cu = np.concatenate([np.asarray(t[1]) for t in tabs])
    juk, juc = jjk.compact_key_table(jnp.asarray(ku), jnp.asarray(cu), jnp)
    for fn in (merge_key_tables, merge_key_tables_plain):
        uk, uc, _dense = fn(_t(ku), _t(cu), vocab)
        _same(uk, juk)
        _same(uc, juc)
    whole_uk, whole_uc = jtable(0, R)
    n = int((np.asarray(whole_uk) != INVALID).sum())
    np.testing.assert_array_equal(np.asarray(juk)[:n],
                                  np.asarray(whole_uk)[:n])
    np.testing.assert_array_equal(np.asarray(juc)[:n],
                                  np.asarray(whole_uc)[:n])
    assert (np.asarray(juk)[n:] == INVALID).all() and n > 0


def _jax_table(plan, rv, cols, a=0, b=None):
    """The JAX package's provider_key_table over rows [a, b)."""
    return jjk.provider_key_table(
        plan, jnp.int32(1),
        {k: jnp.asarray(v[a:b]) for k, v in rv.items()},
        {ck: {k: jnp.asarray(v[a:b]) for k, v in c.items()}
         for ck, c in cols.items()}, jnp)


def _scatter_np(uk, uc, vocab):
    """numpy: uc scattered at uk's valid keys into zeros [max(vocab, 1)]."""
    uk, uc = np.asarray(uk), np.asarray(uc)
    want = np.zeros(max(vocab, 1), np.int32)
    keep = uk != INVALID
    want[uk[keep]] = uc[keep]
    return want


@pytest.mark.parametrize("slot", [False, True])
@pytest.mark.parametrize("scope", ["namespace", "cluster"])
@pytest.mark.parametrize("vocab", [1, 7, 8, 4097])
def test_plain_dense_counts_scatter_the_jax_table(slot, scope, vocab):
    """K7's third output in its plain version: the JAX package's
    provider_key_table (uk, uc) scattered into zeros [max(V, 1)]."""
    rng = np.random.default_rng(vocab + 2 * slot + 4 * (scope == "cluster"))
    R, S = 300, 3
    rv, cols = _rows(rng, R, S, vocab, slot)
    plan = _plan(slot, scope)
    juk, juc = _jax_table(plan, rv, cols)
    col = cols[("joinkey", "k")]
    uk, uc, dense = join_keys_plain(
        _t(rv["valid"]), _t(rv["kind"]), _t(rv["ns_empty"]), _t(col["sid"]),
        _t(col["mask"]) if slot else None, 1, scope == "namespace", vocab)
    _same(uk, juk)
    _same(uc, juc)
    assert dense.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(),
                                  _scatter_np(juk, juc, vocab))
    assert int(dense.sum()) == int(np.asarray(juc).sum()) > 0


def _lookup_dense(dense, q):
    """What K8's dense mode computes: ``dense[q]`` where ``0 <= q <
    len(dense)``, else 0."""
    V = dense.shape[0]
    inside = (q >= 0) & (q < V)
    got = dense[torch.where(inside, q, torch.zeros_like(q)).long()]
    return torch.where(inside, got, torch.zeros_like(got))


@pytest.mark.parametrize("vocab", [1, 7, 8, 4097])
@pytest.mark.parametrize("table", ["sweep", "empty"])
def test_lookup_through_dense_equals_lookup_counts(vocab, table):
    """K8's two modes in their plain forms: a count read from the dense
    counts equals the searchsorted lookup of the same table, on queries
    that include -1, UNKNOWN_KEY, V - 1, V and V + 2."""
    rng = np.random.default_rng(vocab)
    if table == "sweep":
        rv, cols = _rows(rng, 200, 2, vocab, True)
        col = cols[("joinkey", "k")]
        uk, uc, dense = join_keys_plain(
            _t(rv["valid"]), _t(rv["kind"]), _t(rv["ns_empty"]),
            _t(col["sid"]), _t(col["mask"]), 1, True, vocab)
        assert int((uk != INVALID).sum()) > 0
    else:
        uk = _t(np.full(16, INVALID, np.int32))
        uc = _t(np.zeros(16, np.int32))
        dense = tjk.dense_counts(uk, uc, vocab)
    q = rng.integers(-6, vocab + 3, (64, 2)).astype(np.int32)
    q.reshape(-1)[:6] = (-1, tjk.UNKNOWN_KEY, vocab - 1, vocab, vocab + 2, 0)
    want = jjk.lookup_counts(np.asarray(uk), np.asarray(uc), q, np)
    for qq in (_t(q), _t(q[:, 0].copy())):
        got = _lookup_dense(dense, qq)
        assert torch.equal(got, tjk.lookup_counts(uk, uc, qq, torch))
    np.testing.assert_array_equal(
        _lookup_dense(dense, _t(q)).numpy(), want)


@pytest.mark.parametrize("slot", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 8])
def test_merged_dense_equals_the_whole_row_axis(slot, W):
    """The dense counts of the merge of W shard tables equal those of the
    whole row axis's table, and the JAX table scattered."""
    rng = np.random.default_rng(5 * W + slot)
    R, S, vocab = 96, 3, 20
    rv, cols = _rows(rng, R, S, vocab, slot)
    plan = _plan(slot, "cluster")
    trv = {k: _t(v) for k, v in rv.items()}
    tcols = {ck: {k: _t(v) for k, v in c.items()} for ck, c in cols.items()}
    slab = -(-R // W)
    cuts = [min(R, s * slab) for s in range(W + 1)]
    shards = [({k: v[a:b] for k, v in trv.items()},
               {ck: {k: v[a:b] for k, v in c.items()}
                for ck, c in tcols.items()}) for a, b in zip(cuts, cuts[1:])]
    muk, muc, mdense = tjk.provider_key_table(
        plan, 1, [r for r, _c in shards], [c for _r, c in shards], torch,
        axis_name="data", vocab=vocab)
    col = tcols[("joinkey", "k")]
    _uk, _uc, whole = join_keys(trv["valid"], trv["kind"], trv["ns_empty"],
                                col["sid"], col.get("mask"), 1, False, vocab)
    assert torch.equal(mdense, whole)
    juk, juc = _jax_table(plan, rv, cols)
    np.testing.assert_array_equal(mdense.numpy(),
                                  _scatter_np(juk, juc, vocab))
    assert torch.equal(tjk.dense_counts(muk, muc, vocab), mdense)


def test_join_binding_carries_dense_in_trace_mode_only():
    """'trace' mode: the table K7 builds, with its dense counts; 'tables'
    mode: the host index's table, dense None, unless the arguments carry
    one (a mesh's merged table)."""
    rng = np.random.default_rng(9)
    vocab = 30
    rv, cols = _rows(rng, 64, 2, vocab, True)
    trv = {k: _t(v) for k, v in rv.items()}
    tcols = {ck: {k: _t(v) for k, v in c.items()} for ck, c in cols.items()}
    plan = _plan(True, "namespace")
    env = type("Env", (), {"cols": tcols})()
    jb = tjk.JoinBinding("trace", (plan,), [{"kind_id": 1, "vocab": vocab}],
                         rv=trv)
    uk, uc, dense = jb.table(0, env)
    col = tcols[("joinkey", "k")]
    want = join_keys_plain(trv["valid"], trv["kind"], trv["ns_empty"],
                           col["sid"], col["mask"], 1, True, vocab)
    for got, w in zip((uk, uc, dense), want):
        assert torch.equal(got, w)
    assert jb.table(0, env)[2] is dense  # cached
    host = {"uk": uk, "uc": uc, "kind_id": 1}
    tb = tjk.JoinBinding("tables", (plan,), [host], rv=trv)
    assert tb.table(0, env)[2] is None
    mb = tjk.JoinBinding("tables", (plan,), [{**host, "dense": dense}],
                         rv=trv)
    assert mb.table(0, env)[2] is dense


def test_merge_of_empty_and_invalid_tables():
    empty = _t(np.zeros(0, np.int32))
    uk, uc, dense = merge_key_tables(empty, empty, 5)
    assert uk.numel() == uc.numel() == 0
    assert dense.tolist() == [0] * 5
    keys = _t(np.full(6, INVALID, np.int32))
    uk, uc, dense = merge_key_tables(keys, _t(np.zeros(6, np.int32)), 5)
    assert (uk == INVALID).all() and (uc == 0).all()
    assert dense.tolist() == [0] * 5


def _tables():
    """(uk, uc) pairs: a sweep-form table with a KEY_INVALID tail, a host
    table of width TABLE_MIN, a table with no tail, and an empty one."""
    sweep = (np.array([0, 3, 7, 12, INVALID, INVALID, INVALID], np.int32),
             np.array([2, 1, 5, 3, 0, 0, 0], np.int32))
    st = tjk.JoinState((_plan(False, "namespace"),), 0)
    st.providers = [{4: {1, 2}, 9: {3}}]
    host = st.delta_tables()[0]
    assert host["uk"].shape == (tjk.TABLE_MIN,)
    full = (np.array([1, 2, 30], np.int32), np.array([4, 1, 2], np.int32))
    empty = (np.full(tjk.TABLE_MIN, INVALID, np.int32),
             np.zeros(tjk.TABLE_MIN, np.int32))
    return [sweep, (host["uk"], host["uc"]), full, empty]


@pytest.mark.parametrize("table", range(4))
def test_lookup_counts_bit_equal(table):
    uk, uc = _tables()[table]
    q = np.array([[0, 3, 4, 7, 12, 13, -1, tjk.UNKNOWN_KEY, INVALID, 9, 30,
                   31, 2, 1]], np.int32)
    got = tjk.lookup_counts(_t(uk), _t(uc), _t(q), torch)
    _same(got, jjk.lookup_counts(jnp.asarray(uk), jnp.asarray(uc),
                                 jnp.asarray(q), jnp))
    np.testing.assert_array_equal(
        tjk.lookup_counts(uk, uc, q, np),
        np.asarray(jjk.lookup_counts(uk, uc, q, np)))


def test_join_lookup_plain_subtracts_participating_rows():
    """The self-exclusion: 1 less where the row itself is a valid provider
    of the plan's kind in its scope, on rows of the wrong kind and scope
    too, for scalar and slot queries."""
    uk, uc = (_t(a) for a in _tables()[0])
    valid = _t(np.array([True, True, True, False]))
    kind = _t(np.array([1, 1, 2, 1], np.int32))
    ns_empty = _t(np.array([False, True, False, False]))
    q = _t(np.array([7, 7, 7, 7], np.int32))
    for namespaced, want in ((True, [4, 5, 5, 5]), (False, [5, 4, 5, 5])):
        got = join_lookup_plain(uk, uc, q,
                                (valid, kind, ns_empty, 1, namespaced))
        assert got.tolist() == want
    q2 = _t(np.array([[7, 0], [-1, 12], [3, 3], [7, 7]], np.int32))
    got = join_lookup_plain(uk, uc, q2, (valid, kind, ns_empty, 1, True))
    assert got.tolist() == [[4, 1], [0, 3], [1, 1], [5, 5]]
    assert join_lookup_plain(uk, uc, q2).tolist() == \
        [[5, 2], [0, 3], [1, 1], [5, 5]]


def _warp_lower_bound(uk, key):
    """kernels/joinlookup.cu lower_bound_warp, its 32 lanes on the host
    -> (the lower bound of ``key`` in ``uk``, the dependent steps)."""
    lo, hi, steps = 0, len(uk), 0
    while True:
        n = hi - lo
        steps += 1
        if n <= 32:
            b = [lane < n and uk[lo + lane] >= key for lane in range(32)]
            return (lo + b.index(True) if any(b) else hi), steps
        step = -(-n // 32)
        b = [uk[min(lo + (lane + 1) * step - 1, hi - 1)] >= key
             for lane in range(32)]
        if not any(b):
            return hi, steps
        f = b.index(True)
        hi = min(lo + (f + 1) * step - 1, hi - 1)
        lo += f * step


@pytest.mark.parametrize("T,n_keys,steps", [
    (0, 0, 1), (1, 1, 1), (8, 3, 1), (8, 8, 1), (32, 32, 1), (33, 20, 2),
    (1000, 999, 2), (1025, 700, 3), (65536, 40000, 4), (65536, 65536, 4),
    (1 << 20, 300000, 4)])
def test_warp_search_is_the_lower_bound(T, n_keys, steps):
    """K8's table-mode search, a warp's 32-ary lower bound, lands where
    searchsorted does on tables with and without a KEY_INVALID tail, for
    keys in the table, between its keys, before and past all of them; in
    at most log32(T) + 1 dependent steps (4 at T = 65,536, one at T <=
    32), where a binary search takes log2(T)."""
    rng = np.random.default_rng(T + n_keys)
    vocab = 3 * max(n_keys, 4)
    uk = np.full(T, INVALID, np.int64)
    uk[:n_keys] = np.sort(rng.choice(vocab, n_keys, replace=False))
    keys = list(rng.integers(-2, vocab + 3, 300)) + [0, vocab + 9, INVALID]
    if n_keys:
        picks = rng.choice(uk[:n_keys], min(n_keys, 200), replace=False)
        keys += [int(k) + dk for k in picks for dk in (-1, 0, 1)]
        keys += [int(uk[0]), int(uk[n_keys - 1])]
    most = 0
    for key in keys:
        got, n = _warp_lower_bound(uk, key)
        assert got == np.searchsorted(uk, key, "left"), (T, key)
        most = max(most, n)
    assert most <= steps


def _jax_self_mask(valid, kind, ns_empty, kind_id, namespaced):
    """The JAX package's JoinBinding.self_mask on numpy rows."""
    import types

    plan = types.SimpleNamespace(
        remote_scope="namespace" if namespaced else "cluster")
    fake = types.SimpleNamespace(
        plans=[plan], plan_args=[{"kind_id": kind_id}],
        rv={"valid": valid, "kind": kind, "ns_empty": ns_empty})
    return jjk.JoinBinding.self_mask(fake, 0, types.SimpleNamespace(xp=np))


@pytest.mark.parametrize("T", [8, 64, 4096, 65536])
def test_join_lookup_many_equals_each_lookup_and_jax(T):
    """join_lookup_many's plain version (what K8's one table-mode launch
    is held against) gives each lookup's join_lookup_plain counts, and
    the JAX package's lookup_counts less its self-exclusion (self_mask),
    for lookups of different T, S and scope in one call: queries at -1,
    UNKNOWN_KEY, the first and the last key, between keys and past every
    key, scope off, namespaced and cluster, and an empty lookup."""
    from gatekeeper_tpu_torch.ops.joinlookup import (join_lookup_many,
                                                     join_lookup_many_plain)

    rng = np.random.default_rng(T)

    def lookup(T, n_keys, shape, scope):
        vocab = 2 * max(n_keys, 8)
        uk = np.full(T, INVALID, np.int32)
        uc = np.zeros(T, np.int32)
        uk[:n_keys] = np.sort(rng.choice(vocab, n_keys, replace=False))
        uc[:n_keys] = rng.integers(1, 40, n_keys)
        q = rng.integers(-6, vocab + 3, shape).astype(np.int32)
        flat = q.reshape(-1)
        flat[rng.random(flat.size) < 0.5] = rng.choice(
            uk[:max(n_keys, 1)], 1)[0] if n_keys else 0
        special = [-1, tjk.UNKNOWN_KEY, vocab + 2] + (
            [uk[0], uk[n_keys - 1]] if n_keys else [])
        flat[:min(flat.size, len(special))] = special[:flat.size]
        R = shape[0]
        rows = None
        if scope is not None:
            rows = (rng.random(R) < 0.8, rng.integers(0, 3, R).astype(
                np.int32), rng.random(R) < 0.5, 1, scope)
        return uk, uc, q, rows

    specs = [lookup(T, T - T // 4, (40,), None),
             lookup(T, T // 2, (33, 2), True),
             lookup(8, 5, (17, 3), False),
             lookup(T, T, (9, 1), True),
             lookup(max(8, T // 8), 3, (0, 2), False)]
    lookups = [(_t(uk), _t(uc), _t(q),
                None if rows is None else tuple(_t(a) for a in rows[:3])
                + rows[3:]) for uk, uc, q, rows in specs]
    tdev.reset_launches()
    got = join_lookup_many(lookups)
    assert all(v == 0 for v in tdev.launches.values())
    assert [g.shape for g in got] == [lk[2].shape for lk in lookups]
    plain = join_lookup_many_plain(lookups)
    for g, p, lk, (uk, uc, q, rows) in zip(got, plain, lookups, specs):
        assert torch.equal(g, p)
        assert torch.equal(g, join_lookup_plain(*lk))
        want = np.asarray(jjk.lookup_counts(uk, uc, q, np))
        if rows is not None:
            part = _jax_self_mask(*rows).astype(np.int32)
            want = want - (part[:, None] if q.ndim == 2 else part)
        np.testing.assert_array_equal(g.numpy(), want)
    assert join_lookup_many([]) == []


@pytest.mark.parametrize("T,N", [(8, 16), (32768, 16), (65536, 32),
                                 (262144, 262144)])
def test_table_mode_bound_counts_what_the_searches_touch(T, N):
    """chip_smoke's table-mode bound: each query's 4 bytes in and 4 out,
    one binary search's keys and the count it finds a query, never more
    of the table than it holds."""
    import math

    import chip_smoke

    uk = torch.arange(T, dtype=torch.int32)
    q = torch.zeros(N, dtype=torch.int32)
    nbytes, ops, shapes, _lib = chip_smoke._joinlookup_work(
        ((uk, uk, q, None), {}))
    steps = math.ceil(math.log2(T + 1))
    assert nbytes == 8 * N + 4 * min(T, N * steps) + 4 * min(T, N)
    assert nbytes <= 8 * N + 8 * T
    assert ops == N * (steps + 2) and shapes["mode"] == "table"


def test_int_and_str_twins_never_share_a_key():
    """5 and "5" intern to two keys, so their groups are counted apart;
    5 and 5.0 share one."""
    from gatekeeper_tpu_torch.ops.interning import Interner

    it = Interner()
    ids = [tjk.intern_join_key(v, it) for v in (5, "5", 5, 5.0, "5")]
    assert ids[0] == ids[2] == ids[3] != ids[1] == ids[4]
    rv = {"valid": _t(np.ones(5, bool)),
          "kind": _t(np.zeros(5, np.int32)),
          "ns_empty": _t(np.zeros(5, bool))}
    sid = _t(np.array(ids, np.int32))
    uk, uc, dense = join_keys(rv["valid"], rv["kind"], rv["ns_empty"], sid,
                              None, 0, True, len(it))
    got = {int(k): int(c) for k, c in zip(uk, uc) if int(k) != INVALID}
    assert got == {ids[0]: 3, ids[1]: 2}
    assert {k: int(c) for k, c in enumerate(dense) if c} == got


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    tdev.reset_launches()
    rng = np.random.default_rng(5)
    rv, cols = _rows(rng, 33, 3, 12, True)
    col = cols[("joinkey", "k")]
    args = (_t(rv["valid"]), _t(rv["kind"]), _t(rv["ns_empty"]),
            _t(col["sid"]), _t(col["mask"]), 1, False, 12)
    uk, uc, dense = join_keys(*args)
    puk, puc, pdense = join_keys_plain(*args)
    assert torch.equal(uk, puk) and torch.equal(uc, puc)
    assert torch.equal(dense, pdense)
    scope = (args[0], args[1], args[2], 1, False)
    assert torch.equal(join_lookup(uk, uc, args[3], scope, dense=dense),
                       join_lookup_plain(uk, uc, args[3], scope))
    assert tdev.launches["joinkeys"] == tdev.launches["joinlookup"] == 0


# ---------------------------------------------------------------------------
# the join-mode sweep mask, against TpuDriver's
# ---------------------------------------------------------------------------


def _tpu():
    d = TpuDriver()
    d.mesh_enabled = False
    d._mesh_cache = None
    return d


def _clients(templates, constraints, objs):
    """The port, TpuDriver and the oracle, fed the same objects."""
    out = []
    for c in (TorchClient(driver=TorchDriver(device="cpu")),
              JaxClient(driver=_tpu()), JaxClient(driver=InterpDriver())):
        for t in templates:
            c.add_template(copy.deepcopy(t))
        for k in constraints:
            c.add_constraint(copy.deepcopy(k))
        for o in objs:
            c.add_data(copy.deepcopy(o))
        out.append(c)
    return out


def _synthetic(n_templates, n_objs, seed=0):
    templates, constraints = jsyn.make_referential_templates(n_templates,
                                                             seed)
    return _clients(templates, constraints,
                    jsyn.make_referential_objects(n_objs, seed + 1))


def _join_corpus():
    from .render_corpus import join_corpus

    entries = join_corpus()
    return (
        [t for _n, t, _c, _o in entries],
        [c for _n, _t, c, _o in entries],
        [o for *_x, objs in entries for o in objs],
    )


def _mask_rows(drv, mask):
    st = drv._delta_state
    return np.asarray(mask)[np.asarray(st.crow)][:, :drv._audit_pack.n_rows]


@pytest.mark.parametrize("corpus", ["synthetic", "join_corpus"])
def test_join_mode_mask_bit_equal_to_tpu_fused_mask(corpus):
    """The port's resident [C, R] sweep mask equals the one TpuDriver's
    _fused_mask_fn computes (its MaskSource after a full sweep): join
    verdicts exact, never the review mode's defaults."""
    if corpus == "synthetic":
        t, j, o = _synthetic(6, 240)
    else:
        t, j, o = _clients(*_join_corpus())
    for c in (t, j):
        c.audit_capped(20)
    td, jd = t.driver, j.driver
    assert td.last_sweep_stats["join_plans"] == 3.0
    want = _mask_rows(jd, jd._delta_state.mask_src.get())
    got = _mask_rows(td, td._delta_state.mask_src.get().numpy())
    np.testing.assert_array_equal(got, want)
    assert got.any()
    # and not the review-mode mask: it flags more
    side = td._constraint_side()
    rv_d, cols_d = td._audit_dev[1]
    review_mode, _ = td._eval(side, rv_d, cols_d, td._constraint_device(side))
    assert _mask_rows(td, review_mode.numpy()).sum() > got.sum()


# ---------------------------------------------------------------------------
# end-to-end parity with the oracle (tests/test_joinkernel.py's scenarios)
# ---------------------------------------------------------------------------


def _parity(t, o, j=None):
    """audit_capped and audit on the port equal the oracle's, byte for
    byte; with TpuDriver given, its path and join statistics too.  ->
    (the capped results, totals, the capped sweep's statistics)."""
    rt, tt = t.audit_capped(CAP)
    stats = dict(t.driver.last_sweep_stats)
    ro, to = o.audit_capped(CAP)
    assert sig(rt.results()) == sig(ro.results())
    assert tt == to
    if j is not None:
        rj, tj = j.audit_capped(CAP)
        assert tj == tt
        for key in ("delta_rows", "join_affected_rows", "cached"):
            assert t.driver.last_sweep_stats.get(key) == \
                j.driver.last_sweep_stats.get(key), key
    assert sig(t.audit().results()) == sig(o.audit().results())
    return rt.results(), tt, stats


def _ingress(i, host):
    return {
        "apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
        "metadata": {"name": f"ing-{i}", "namespace": "ns-0"},
        "spec": {"rules": [{"host": host}]},
    }


def test_synthetic_corpus_byte_parity():
    t, j, o = _synthetic(6, 48)
    res, _, stats = _parity(t, o, j)
    assert res
    assert stats["join_plans"] == 3.0


def test_all_one_group():
    templates, constraints = jsyn.make_referential_templates(3)
    t, j, o = _clients(templates, constraints,
                       [_ingress(i, "only.corp.io") for i in range(7)])
    _res, totals, _ = _parity(t, o, j)
    dup = [v for (kind, _n), v in totals.items() if "Uniquehost" in kind]
    assert dup and dup[0][0] == 7


def test_empty_groups():
    """No StorageClass at all (every reference dangles) and one ingress
    with a unique host (no duplicates)."""
    objs = [
        {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
         "metadata": {"name": f"p-{i}", "namespace": "ns-0"},
         "spec": {"storageClassName": f"cls-{i}"}}
        for i in range(4)
    ] + [_ingress(0, "solo.corp.io")]
    templates, constraints = jsyn.make_referential_templates(3)
    t, j, o = _clients(templates, constraints, objs)
    _res, totals, _ = _parity(t, o, j)
    exists = [v for (kind, _n), v in totals.items() if "Requiredclass" in kind]
    assert exists and exists[0][0] == 4
    assert not any(n for (kind, _n), (n, _h) in totals.items()
                   if "Uniquehost" in kind)


def test_int_vs_str_team_labels_never_pool():
    pods = [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": f"p{tag}-{i}", "namespace": "ns-0",
                      "labels": {"team": team}}, "spec": {}}
        for tag, team, n in (("i", 5, 3), ("s", "5", 2)) for i in range(n)
    ]
    templates, constraints = jsyn.make_referential_templates(3)
    quota = [(tt, c) for tt, c in zip(templates, constraints)
             if "Teamquota" in c["kind"]][0]
    c = copy.deepcopy(quota[1])
    c["spec"]["parameters"] = {"limit": 2}
    t, j, o = _clients([quota[0]], [c], pods)
    res, _, _ = _parity(t, o, j)
    names = sorted(r.review["object"]["metadata"]["name"] for r in res)
    assert names == ["pi-0", "pi-1", "pi-2"]
    assert all("has 3 pods (limit 2)" in r.msg for r in res)


def test_tombstoned_rows_leave_groups():
    t, j, o = _synthetic(3, 30)
    _parity(t, o, j)
    for obj in jsyn.make_referential_objects(30, 1):
        if obj["kind"] == "Ingress":
            for c in (t, j, o):
                c.remove_data(copy.deepcopy(obj))
    _res, totals, _ = _parity(t, o, j)
    assert not any(n for (kind, _n), (n, _h) in totals.items()
                   if "Uniquehost" in kind)


# ---------------------------------------------------------------------------
# the delta path: key-group locality
# ---------------------------------------------------------------------------


def _warm(n_t=6, n_r=48):
    t, j, o = _synthetic(n_t, n_r)
    for c in (t, j, o):
        c.audit_capped(CAP)
    return t, j, o


def _each(clients, method, obj):
    for c in clients:
        getattr(c, method)(copy.deepcopy(obj))


def test_churn_dispatches_only_key_group():
    """An Ingress moving to a shared host: the delta sweep dispatches the
    churned row plus the readers of its old and new host groups, the
    same rows TpuDriver dispatches, and its results equal the oracle's."""
    t, j, o = _warm()
    objs = jsyn.make_referential_objects(48, 1)
    victim = [x for x in objs if x["kind"] == "Ingress"][0]
    old_host = victim["spec"]["rules"][0]["host"]
    victim = {**victim, "spec": {"rules": [{"host": "app-0.corp.io"}]}}
    host_rows = {}
    for x in objs:
        if x["kind"] == "Ingress":
            for r in x["spec"]["rules"]:
                host_rows.setdefault(r["host"], set()).add(
                    x["metadata"]["name"])
    expect = (host_rows.get(old_host, set())
              | host_rows.get("app-0.corp.io", set())) \
        - {victim["metadata"]["name"]}
    assert expect, "the corpus must hold a shared host group"
    _each((t, j, o), "add_data", victim)
    _res, _tot, st = _parity(t, o, j)
    assert st["delta_rows"] == float(1 + len(expect)), st
    assert st["join_affected_rows"] == float(len(expect)), st


def test_churn_parity_vs_oracle():
    t, j, o = _warm()
    pod = [x for x in jsyn.make_referential_objects(48, 1)
           if x["kind"] == "Pod"][0]
    pod = {**pod, "metadata": {**pod["metadata"], "labels": {"team": "beta"}}}
    _each((t, j, o), "add_data", pod)
    _res, _tot, st = _parity(t, o, j)
    assert "delta_rows" in st


def test_render_cache_reuses_unchanged_referential_results():
    """A join-safe template's results are content-keyed: after a churn of
    one PVC the sweep renders fewer cells than the full one did."""
    t, _j, _o = _warm()
    drv = t.driver
    full_render = drv.last_sweep_stats["rendered_cells"]
    pvc = [x for x in jsyn.make_referential_objects(48, 1)
           if x["kind"] == "PersistentVolumeClaim"][0]
    t.add_data({**pvc, "spec": {"storageClassName": "gold"}})
    t.audit_capped(CAP)
    st = drv.last_sweep_stats
    assert "delta_rows" in st
    assert st["rendered_cells"] < full_render


def test_full_sweep_diff_bumps_affected_readers():
    """Churn past the delta budget takes the full path, whose join index
    diff still invalidates the affected readers' cached renders (no stale
    quota counts)."""
    t, j, o = _warm(3, 24)
    for c in (t, j):
        c.driver.DELTA_MAX_ROWS = 0
    pod = [x for x in jsyn.make_referential_objects(24, 1)
           if x["kind"] == "Pod"][0]
    pod = {**pod, "metadata": {**pod["metadata"],
                               "labels": {"team": "alpha"}}}
    _each((t, j, o), "add_data", pod)
    rt, tt = t.audit_capped(CAP)
    assert "delta_rows" not in t.driver.last_sweep_stats
    ro, to = o.audit_capped(CAP)
    assert sig(rt.results()) == sig(ro.results()) and tt == to


def test_group_past_the_delta_budget_takes_the_full_path():
    """A churned Pod whose team group's readers exceed DELTA_MAX_ROWS
    takes the full path, on the port as on TpuDriver; a churn inside a
    small group stays on the delta path."""
    pods = [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": f"crowd-{i}", "namespace": f"ns-{i % 3}",
                      "labels": {"team": "crowded"}}, "spec": {}}
        for i in range(12)
    ] + [
        {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": f"solo-{i}", "namespace": "ns-0",
                      "labels": {"team": f"t-{i}"}}, "spec": {}}
        for i in range(6)
    ]
    templates, constraints = jsyn.make_referential_templates(3)
    t, j, o = _clients(templates, constraints, pods)
    for c in (t, j, o):
        c.audit_capped(CAP)
    for c in (t, j):
        c.driver.DELTA_MAX_ROWS = 8
    moved = copy.deepcopy(pods[0])
    moved["spec"] = {"priority": 1}  # key-neutral, no packed width grows
    _each((t, j, o), "add_data", moved)
    assert _parity(t, o, j)[2]["delta_rows"] == 1.0
    moved = copy.deepcopy(pods[1])
    moved["metadata"]["labels"]["team"] = "t-0"  # leaves the crowd
    _each((t, j, o), "add_data", moved)
    assert "delta_rows" not in _parity(t, o, j)[2]
    moved = copy.deepcopy(pods[12])
    moved["metadata"]["labels"]["team"] = "t-1"  # joins a small group
    _each((t, j, o), "add_data", moved)
    st = _parity(t, o, j)[2]
    assert st["delta_rows"] == 3.0 and st["join_affected_rows"] == 2.0, st


def test_forced_full_sweep_after_churn_equals_the_delta_path():
    """Churn through the delta path, then a forced full sweep: its key
    tables are built from the resident columns the row scatter patched,
    and it must equal the delta path in totals, results and counts."""
    t, j, o = _warm()
    objs = jsyn.make_referential_objects(48, 1)
    ing = [x for x in objs if x["kind"] == "Ingress"][1]
    pvc = [x for x in objs if x["kind"] == "PersistentVolumeClaim"][1]
    _each((t, j, o), "add_data",
          {**ing, "spec": {"rules": [{"host": "fresh.corp.io"}]}})
    _each((t, j, o), "add_data",
          {**pvc, "spec": {"storageClassName": "missing-9"}})
    rt, tt = t.audit_capped(CAP)
    drv = t.driver
    assert "delta_rows" in drv.last_sweep_stats
    counts = drv._delta_state.counts.copy()
    drv._delta_state = None
    drv._audit_cache = None
    rf, tf = t.audit_capped(CAP)
    assert drv.last_sweep_stats["scatter_rows"] == 2.0
    assert tf == tt and sig(rf.results()) == sig(rt.results())
    np.testing.assert_array_equal(drv._delta_state.counts, counts)
    ro, to = o.audit_capped(CAP)
    assert sig(rf.results()) == sig(ro.results()) and tf == to


def test_divergence_assertion_stays_quiet_on_a_clean_corpus(monkeypatch):
    monkeypatch.setenv("GK_JOIN_ASSERT", "1")
    t, _j, o = _synthetic(6, 96)
    _parity(t, o)
    obj = [x for x in jsyn.make_referential_objects(96, 1)
           if x["kind"] == "Ingress"][3]  # svc-9 moves to a shared host
    _each((t, o), "add_data",
          {**obj, "spec": {"rules": [{"host": "app-1.corp.io"}]}})
    assert "delta_rows" in _parity(t, o)[2]


def test_capped_sweep_renders_no_more_cells_than_tpu_driver():
    """24 templates x 1,500 objects: with exact join verdicts the port's
    capped sweep renders the cells TpuDriver renders, not every matched
    row of every referential constraint."""
    templates, constraints = jsyn.make_referential_templates(24)
    objs = jsyn.make_referential_objects(1500, 1)
    out = []
    for c in (TorchClient(driver=TorchDriver(device="cpu")),
              JaxClient(driver=_tpu())):
        for tt, k in zip(templates, constraints):
            c.add_template(copy.deepcopy(tt))
            c.add_constraint(copy.deepcopy(k))
        for x in objs:
            c.add_data(copy.deepcopy(x))
        resp, totals = c.audit_capped(20)
        out.append((c.driver.last_sweep_stats["rendered_cells"],
                    sig(resp.results()), totals))
    (t_cells, t_sig, t_tot), (j_cells, j_sig, j_tot) = out
    assert t_sig == j_sig and t_tot == j_tot
    assert t_cells <= j_cells, (t_cells, j_cells)
