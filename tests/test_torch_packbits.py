"""The bit-packed review download (gatekeeper_tpu_torch/ops/packbits.py, the
plain version the CPU runs, and TorchDriver.compute_masks through it)
against the JAX package: ``jnp.packbits(jnp.concatenate([mask,
autoreject]), axis=1)``, the packing of gatekeeper_tpu/ops/driver.py
_packed_variant, and TpuDriver.compute_masks on the CPU JAX backend.  The
masks are made from a numpy seed.  Tolerance 0: every compared value is a
byte or a bool."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.client.client import Client as JaxClient
from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu.util import synthetic as jsyn
from gatekeeper_tpu_torch import device as dev
from gatekeeper_tpu_torch.client.client import Client as TorchClient
from gatekeeper_tpu_torch.ops import packbits
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.util import synthetic as tsyn

from .render_corpus import corpus, resources, review_of


def _masks(C, R, fill, seed):
    rng = np.random.default_rng(seed)
    if fill == "random":
        return rng.random((C, R)) < 0.3, rng.random((C, R)) < 0.1
    value = fill == "all_true"
    return np.full((C, R), value), np.full((C, R), not value)


def _jax_packed(mask, rej):
    return np.asarray(jnp.packbits(jnp.concatenate(
        [jnp.asarray(mask), jnp.asarray(rej)], axis=0), axis=1))


@pytest.mark.parametrize("fill", ["random", "all_true", "all_false"])
@pytest.mark.parametrize("C", [0, 1, 5, 128])
@pytest.mark.parametrize("R", [1, 7, 8, 9, 64, 4099])
def test_plain_bit_equal_to_jnp_packbits(R, C, fill):
    mask, rej = _masks(C, R, fill, seed=R * 1000 + C)
    want = _jax_packed(mask, rej)
    got = packbits.pack_review_masks_plain(torch.from_numpy(mask),
                                           torch.from_numpy(rej))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert want.shape == (2 * C, -(-R // 8))
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatcher takes the plain version on the CPU
    np.testing.assert_array_equal(packbits.pack_review_masks(
        torch.from_numpy(mask), torch.from_numpy(rej)).numpy(), want)
    # np.unpackbits undoes it, and the pad bits of the last byte are 0
    both = np.unpackbits(got.numpy(), axis=1)
    np.testing.assert_array_equal(both[:, :R], np.concatenate([mask, rej]))
    assert not both[:, R:].any()


def test_column_8j_is_the_most_significant_bit():
    mask = torch.zeros((1, 12), dtype=torch.bool)
    mask[0, 0] = mask[0, 9] = True
    got = packbits.pack_review_masks_plain(mask, torch.ones_like(mask))
    assert got.tolist() == [[0b10000000, 0b01000000],
                            [0b11111111, 0b11110000]]


@pytest.fixture
def launched(monkeypatch):
    """device.launch recording its arguments, on CPU tensors."""
    calls = []
    monkeypatch.setattr(dev, "launch",
                        lambda name, device, *args: calls.append(
                            (name, device, args)))
    monkeypatch.setattr(dev, "stream", lambda t: 0)
    return calls


@pytest.mark.parametrize("C, R", [(0, 8), (3, 0), (0, 0)])
def test_cuda_wrapper_skips_the_launch_for_empty_masks(launched, C, R):
    mask = torch.zeros((C, R), dtype=torch.bool)
    out = packbits.pack_review_masks_cuda(mask, mask.clone())
    assert out.dtype == torch.uint8
    assert tuple(out.shape) == (2 * C, -(-R // 8)) and not launched


@pytest.mark.parametrize("R, row0, vec", [
    (8, 0, 1),       # a review's call: one 8-byte word a thread
    (256, 0, 1),
    (13, 0, 0),      # R off a byte: the byte path
    (16, 1, 1),      # a row slice 16 bytes in: still 8-byte aligned
    (13, 1, 0),      # a row slice 13 bytes in: not aligned
])
def test_cuda_wrapper_arguments(launched, R, row0, vec):
    big = torch.zeros((row0 + 4, R), dtype=torch.bool)
    mask = big[row0:row0 + 3]
    rej = torch.zeros((3, R), dtype=torch.bool)
    assert big.data_ptr() % 8 == 0  # the host allocator aligns its blocks
    out = packbits.pack_review_masks_cuda(mask, rej)
    [(name, device, args)] = launched
    assert name == "packbits" and device == mask.device
    assert args == (mask.data_ptr(), rej.data_ptr(), 3, R, vec,
                    out.data_ptr(), 0)
    assert tuple(out.shape) == (6, -(-R // 8))


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(launched):
    mask = torch.zeros((2, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="autoreject"):
        packbits.pack_review_masks_cuda(mask, torch.zeros((3, 8), dtype=bool))
    with pytest.raises(TypeError):
        packbits.pack_review_masks_cuda(mask, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        packbits.pack_review_masks_cuda(
            torch.zeros((8, 2), dtype=torch.bool).t(), mask)
    assert not launched


@pytest.mark.parametrize("rows, width", [(8, 1), (8, 4), (8, 8), (9, 3),
                                         (16, 3), (40, 8)])
def test_unpack_joins_slabs_after_unpacking(rows, width):
    """A mesh's slabs, packed one by one, unpack to the whole mask; the
    packed bytes of slabs that are not a multiple of 8 columns hold pad
    bits, so joining the bytes first would not."""
    rng = np.random.default_rng(rows * 10 + width)
    target = -(-rows // width) * width
    slab = target // width
    C = 5
    mask = rng.random((C, target)) < 0.4
    rej = rng.random((C, target)) < 0.2
    mask[:, rows:] = rej[:, rows:] = False  # the padded tail
    packed = [packbits.pack_review_masks_plain(
        torch.from_numpy(mask[:, s * slab:(s + 1) * slab]),
        torch.from_numpy(rej[:, s * slab:(s + 1) * slab])).numpy()
        for s in range(width)]
    crow = np.array([4, 0, 2])
    got_m, got_r = packbits.unpack_review_masks(packed, slab, crow, rows)
    assert got_m.dtype == np.bool_ and got_m.shape == (3, rows)
    np.testing.assert_array_equal(got_m, mask[crow][:, :rows])
    np.testing.assert_array_equal(got_r, rej[crow][:, :rows])
    if slab % 8:
        joined = np.unpackbits(np.concatenate(packed, axis=1), axis=1)
        assert not np.array_equal(joined[:C][crow][:, :rows],
                                  mask[crow][:, :rows])


# ---------------------------------------------------------------------------
# TorchDriver.compute_masks against TpuDriver.compute_masks
# ---------------------------------------------------------------------------


def _load(client, entries):
    for _name, tmpl, con, _tier in entries:
        client.add_template(copy.deepcopy(tmpl))
        client.add_constraint(copy.deepcopy(con))
    return client


@pytest.fixture(scope="module")
def drivers():
    """(port, TpuDriver) pairs: the synthetic corpus (12 templates x 64
    pods) and the render corpus."""
    entries = corpus()
    return {
        "synthetic": (tsyn.build_driver(12, 64, device="cpu").driver,
                      jsyn.build_driver(12, 64).driver),
        "render_corpus": (
            _load(TorchClient(driver=TorchDriver(device="cpu")),
                  entries).driver,
            _load(JaxClient(driver=TpuDriver()), entries).driver),
    }


def _reviews(source, n, driver):
    if source == "synthetic":
        pods = tsyn.make_pods(n, seed=7, violation_rate=0.5)
    else:
        objs = resources()
        pods = [copy.deepcopy(objs[i % len(objs)]) for i in range(n)]
    for i, p in enumerate(pods):
        p.setdefault("metadata", {})["name"] = f"packed-{i}"
    if source == "synthetic":
        return [driver.target.handle_review(p)[1] for p in pods]
    return [review_of(p) for p in pods]


@pytest.mark.parametrize("source", ["synthetic", "render_corpus"])
@pytest.mark.parametrize("n, rows", [(1, 8), (9, 16)])
def test_compute_masks_bit_equal_to_tpu_driver(drivers, source, n, rows):
    td, jd = drivers[source]
    reviews = _reviews(source, n, td)
    t_ord, t_mask, t_rej = td.compute_masks(reviews)
    j_ord, j_mask, j_rej = jd.compute_masks(copy.deepcopy(reviews))
    assert [o[:2] for o in t_ord] == [o[:2] for o in j_ord]
    assert t_mask.dtype == np.bool_ and t_rej.dtype == np.bool_
    assert t_mask.shape == j_mask.shape == (len(t_ord), rows)
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_rej, j_rej)
    assert t_mask[:, :n].any()
    assert not t_mask[:, n:].any()  # the bucket's pad reviews


def test_compute_masks_downloads_the_packed_array(drivers, monkeypatch):
    """The review's masks come down as one packed uint8 array: the plain
    version of K10 runs once per compute_masks, and its output is what is
    unpacked."""
    td, _jd = drivers["synthetic"]
    calls = []
    orig = packbits.pack_review_masks_plain

    def spy(mask, autoreject):
        out = orig(mask, autoreject)
        calls.append((tuple(mask.shape), out.dtype))
        return out

    monkeypatch.setattr(packbits, "pack_review_masks_plain", spy)
    td.compute_masks(_reviews("synthetic", 3, td))
    C = td._constraint_side()[1].arrays["valid"].shape[0]
    assert calls == [((C, 8), torch.uint8)]


# ---------------------------------------------------------------------------
# K9's review mode on the CPU: program_eval(..., pack=...) against the JAX
# package's fused output, jnp.packbits of TpuDriver's fused masks inside its
# one dispatch (_packed_variant)
# ---------------------------------------------------------------------------


def _jax_fused(jd, reviews, lo, hi):
    """TpuDriver's packed array of review rows [lo, hi), its group-major
    rows picked by crow -> (C, crow, packed)."""
    from gatekeeper_tpu_torch.convert import take_rows

    jd.mesh_enabled = False
    jd._mesh_cache = None
    fn, _ordered, rp, cp, cols, gp, crow = jd._device_inputs(
        copy.deepcopy(reviews))
    rows = np.arange(lo, hi)
    packed = np.asarray(jd._dispatch(
        jd._packed_variant(fn), take_rows(rp.arrays, rows), cp.arrays,
        take_rows(cols, rows), gp, hi - lo))
    C = cp.arrays["valid"].shape[0]
    return packed[np.concatenate([crow, C + np.asarray(crow)])]


def _port_fused(td, reviews, lo, hi):
    """The port's review evaluation of rows [lo, hi) with the pack asked
    of program_eval (on the CPU its plain version), its group-major rows
    picked by crow."""
    from gatekeeper_tpu_torch.convert import state_from_numpy, take_rows

    side, rv, cols, _rows = td._review_pack(reviews)
    rows = np.arange(lo, hi)
    C = side[1].arrays["valid"].shape[0]
    out = packbits.packed_empty(C, hi - lo, "cpu")
    out.fill_(0xA5)  # every byte must be written
    td._eval(side, state_from_numpy(take_rows(rv, rows), "cpu"),
             state_from_numpy(take_rows(cols, rows), "cpu"),
             td._constraint_device(side), pack_out=out)
    crow = np.asarray(side[4])
    return out.numpy()[np.concatenate([crow, C + crow])]


@pytest.mark.parametrize("source", ["synthetic", "render_corpus"])
@pytest.mark.parametrize("R", [1, 7, 8, 9, 256])
def test_fused_pack_bit_equal_to_the_jax_fused_output(drivers, source, R):
    td, jd = drivers[source]
    reviews = _reviews(source, R, td)
    want = _jax_fused(jd, reviews, 0, R)
    got = _port_fused(td, reviews, 0, R)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert want.shape[1] == -(-R // 8)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    # mesh slabs: a shard's rows of the padded batch, packed on their own
    if R in (9, 256):
        for width in (2, 4):
            slab = -(-R // width)
            for s in range(width):
                lo, hi = s * slab, (s + 1) * slab
                np.testing.assert_array_equal(
                    _port_fused(td, reviews, lo, hi),
                    _jax_fused(jd, reviews, lo, hi))


def test_compute_masks_packs_in_the_program_call(drivers, monkeypatch):
    """compute_masks asks program_eval for the pack (K9's review mode),
    with an output of [2C, ceil(R/8)], and downloads that output."""
    from gatekeeper_tpu_torch.ops import driver as driver_mod

    td, _jd = drivers["synthetic"]
    seen = []
    orig = driver_mod.program_eval

    def spy(mask, groups, pack=None):
        seen.append(None if pack is None else
                    (tuple(pack[0].shape), tuple(pack[1].shape)))
        return orig(mask, groups, pack=pack)

    monkeypatch.setattr(driver_mod, "program_eval", spy)
    _o, mask, rej = td.compute_masks(_reviews("synthetic", 3, td))
    C = td._constraint_side()[1].arrays["valid"].shape[0]
    assert seen == [((C, 8), (2 * C, 1))]
    assert mask.shape[1] == 8 and mask[:, :3].any()
