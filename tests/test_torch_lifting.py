"""PyTorch port: the Haar, 13/7 and S+P lifting banks, the packed 2D DWT
with every filter, ``ll_view`` and the edge helpers of ``ops/border.py``,
against the reference goldens and the JAX package (CPU, exact: every
path here is integer)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qsvc_tpu.ops import border as jborder
from qsvc_tpu.ops import dwt2d as jdwt
from qsvc_tpu.ops import lifting as jlifting
from qsvc_tpu_torch.ops import border, dwt2d, lifting

torch.set_num_threads(1)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden",
                              "lifting_golden.npz"))
NAMES = {"haar": "haar", "137": "13/7"}
# the reference's 13/7 odd path reads out of bounds at n = 3..5, so its
# golden vectors there are not the bank's (tests/test_lifting.py skips
# them too)
GOLDEN_CASES = sorted(
    (name, int(key[:-2].rsplit("_", 1)[1]))
    for key in GOLDEN.files for name in NAMES
    if key.startswith(name + "_") and key.endswith("_s")
    and not (name == "137" and 3 <= int(key[:-2].rsplit("_", 1)[1]) <= 5))
INT_BANKS = ["haar", "5/3", "13/7", "sp"]


@pytest.mark.parametrize("name,n", GOLDEN_CASES)
def test_bit_exact_vs_reference(name, n):
    s = GOLDEN[f"{name}_{n}_s"].astype(np.int32)
    l, h = lifting.fwd(NAMES[name], torch.from_numpy(s))
    np.testing.assert_array_equal(l.numpy(), GOLDEN[f"{name}_{n}_l"])
    np.testing.assert_array_equal(h.numpy(), GOLDEN[f"{name}_{n}_h"])
    np.testing.assert_array_equal(lifting.inv(NAMES[name], l, h).numpy(), s)


@pytest.mark.parametrize("filt", INT_BANKS)
@pytest.mark.parametrize("n", range(1, 18))
def test_banks_match_jax(filt, n):
    """Forward and inverse of a (3, 2, n) batch against the JAX bank, and
    perfect reconstruction where the bank defines it (not 13/7 at n = 3,
    5: the reference's boundary unrolling is out of bounds there)."""
    s = np.random.default_rng(n).integers(-255, 256, (3, 2, n)
                                          ).astype(np.int32)
    l, h = lifting.fwd(filt, torch.from_numpy(s))
    jl, jh = jlifting.fwd(filt, jnp.asarray(s))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    assert (l.shape[-1], h.shape[-1]) == (n - n // 2, n // 2)
    r = lifting.inv(filt, l, h)
    np.testing.assert_array_equal(r.numpy(),
                                  np.asarray(jlifting.inv(filt, jl, jh)))
    if not (filt == "13/7" and n in (3, 5)):
        np.testing.assert_array_equal(r.numpy(), s)


@pytest.mark.parametrize("filt", INT_BANKS)
def test_batch_rows_are_1d_transforms(filt):
    s = torch.from_numpy(np.random.default_rng(7).integers(
        -255, 256, (3, 4, 32)).astype(np.int32))
    l, h = lifting.fwd(filt, s)
    l0, h0 = lifting.fwd(filt, s[1, 2])
    assert torch.equal(l[1, 2], l0) and torch.equal(h[1, 2], h0)


def test_shifts_floor_where_tdiv_truncates():
    """13/7 and S+P divide by arithmetic shifts (floor), 5/3 and Haar by
    C truncation: -3 >> 1 == -2 but tdiv(-3, 2) == -1."""
    x = torch.tensor([-3, -1, 3], dtype=torch.int32)
    assert (x >> 1).tolist() == [-2, -1, 1]
    assert lifting.tdiv(x, 2).tolist() == [-1, 0, 1]
    # a negative odd difference: fwd_sp's low band floors, Haar's rounds
    # toward zero
    s = torch.tensor([0, 3], dtype=torch.int32)
    assert lifting.fwd_sp(s)[0].tolist() == [1]
    assert lifting.fwd_haar(s)[0].tolist() == [1]
    s = torch.tensor([0, -3], dtype=torch.int32)
    assert lifting.fwd_sp(s)[0].tolist() == [-2]
    assert lifting.fwd_haar(s)[0].tolist() == [-1]


def test_filter_table_and_axis_dispatch():
    assert set(lifting.FILTERS) == set(jlifting.FILTERS)
    assert lifting.AXIS_AWARE == jlifting.AXIS_AWARE
    x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    with pytest.raises(TypeError):
        lifting.fwd("haar", x, axis=-2)      # last axis only


@pytest.mark.parametrize("filt", INT_BANKS + ["9/7"])
def test_dwt2d_matches_jax(filt):
    """Packed 3-level analysis and synthesis of a (2, 36, 44) stack with
    each filter; the integer banks reconstruct exactly."""
    x = np.random.default_rng(11).integers(0, 256, (2, 36, 44)
                                           ).astype(np.int32)
    a = dwt2d.analyze(torch.from_numpy(x), 3, filt)
    ja = jdwt.analyze(jnp.asarray(x), 3, filt)
    if filt == "9/7":
        # float32: the steps run in the same order, the rounding of a
        # separate op may still differ in the last place
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-3)
        return
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    s = dwt2d.synthesize(a, 3, filt)
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jdwt.synthesize(ja, 3, filt)))
    np.testing.assert_array_equal(s.numpy(), x)


@pytest.mark.parametrize("filt", ["haar", "13/7", "sp"])
@pytest.mark.parametrize("shape", [(2, 18, 22), (1, 17, 23)])
def test_resample_matches_jax(filt, shape):
    """``upsample2``/``downsample2`` with the non-5/3 banks take the
    packed path (odd sizes included)."""
    x = np.random.default_rng(5).integers(0, 256, shape).astype(np.int32)
    for fn in ("upsample2", "downsample2"):
        got = getattr(dwt2d, fn)(torch.from_numpy(x), filt)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jdwt, fn)(jnp.asarray(x), filt)))


@pytest.mark.parametrize("shape,levels", [((2, 36, 44), 3), ((37, 45), 2),
                                          ((3, 8, 8), 5)])
def test_ll_view_matches_jax(shape, levels):
    x = np.random.default_rng(2).integers(0, 256, shape).astype(np.int32)
    got = dwt2d.ll_view(torch.from_numpy(x), levels)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdwt.ll_view(jnp.asarray(x), levels)))


@pytest.mark.parametrize("shape,b", [((2, 3, 10, 12), 3), ((5, 7), 1),
                                     ((1, 4, 6), 0), ((2, 3, 4), 9)])
def test_pad_edge_matches_jax(shape, b):
    """Edge replication of the last two axes under any leading axes, a
    border wider than the frame included."""
    x = np.random.default_rng(4).integers(-300, 300, shape).astype(np.int16)
    got = border.pad_edge(torch.from_numpy(x), b)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jborder.pad_edge(jnp.asarray(x), b)))


@pytest.mark.parametrize("args", [(3, 4, 10, 8, 2), (1, 2, 4, 4, 0),
                                  (2, 2, 16, 8, 4)])
def test_block_index_grids_match_jax(args):
    got = border.block_index_grids(*args, device="cpu")
    for g, w in zip(got, jborder.block_index_grids(*args)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
