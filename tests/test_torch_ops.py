"""PyTorch port: lifting, packed 2D DWT and histogram entropy against the
reference goldens and the JAX package (CPU, small shapes)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qsvc_tpu.ops import dwt2d as jdwt
from qsvc_tpu.ops import entropy as jentropy
from qsvc_tpu_torch.ops import dwt2d, entropy, lifting

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
LIFT = np.load(os.path.join(GOLDEN_DIR, "lifting_golden.npz"))
DWT = np.load(os.path.join(GOLDEN_DIR, "dwt2d_golden.npz"))

LIFT_53 = sorted(int(k[3:-2]) for k in LIFT.files
                 if k.startswith("53_") and k.endswith("_s"))
DWT_CASES = sorted({k.rsplit("_", 1)[0] for k in DWT.files})


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("n", LIFT_53)
def test_53_bit_exact_vs_reference(n, axis):
    s = LIFT[f"53_{n}_s"].astype(np.int32)
    l_ref = LIFT[f"53_{n}_l"].astype(np.int32)
    h_ref = LIFT[f"53_{n}_h"].astype(np.int32)
    x = torch.from_numpy(s)
    if axis == -2:
        x = x[:, None]
    l, h = lifting.fwd53(x, axis=axis)
    np.testing.assert_array_equal(l.reshape(-1).numpy(), l_ref)
    np.testing.assert_array_equal(h.reshape(-1).numpy(), h_ref)
    np.testing.assert_array_equal(
        lifting.inv53(l, h, axis=axis).reshape(-1).numpy(), s)


def test_tdiv_truncates_toward_zero():
    x = torch.tensor([-7, -6, -1, 0, 1, 6, 7], dtype=torch.int16)
    np.testing.assert_array_equal(lifting.tdiv(x, 2).numpy(),
                                  [-3, -3, 0, 0, 0, 3, 3])
    np.testing.assert_array_equal(lifting.tdiv(x, 4).numpy(),
                                  [-1, -1, 0, 0, 0, 1, 1])


@pytest.mark.parametrize("base", DWT_CASES)
def test_dwt2d_bit_exact_vs_reference(base):
    orig = DWT[base + "_orig"].astype(np.int32)
    ana_ref = DWT[base + "_ana"].astype(np.int32)
    syn_ref = DWT[base + "_syn"].astype(np.int32)
    levels = int(base.split("_l")[1])
    ana = dwt2d.analyze(torch.from_numpy(orig), levels)
    np.testing.assert_array_equal(ana.numpy(), ana_ref)
    syn = dwt2d.synthesize(torch.from_numpy(ana_ref), levels)
    np.testing.assert_array_equal(syn.numpy(), syn_ref)


def _jax_97(fn, x, levels):
    """The JAX transform compiled as the codec runs it (jitted)."""
    return jax.jit(fn, static_argnums=(1, 2))(x, levels, "9/7")


@pytest.mark.parametrize("shape,levels", [((3, 37, 50), 3), ((2, 64, 96), 4),
                                          ((1, 17, 19), 2)])
def test_97_matches_jax(shape, levels):
    """Float32 9/7: the same lifting steps in the same order; XLA may
    fuse or reassociate, so agreement is to float32 rounding (1e-3 on
    values of a few hundred)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-128, 127, shape).astype(np.float32)
    want = np.asarray(_jax_97(jdwt.analyze, jnp.asarray(x), levels))
    got = dwt2d.analyze(torch.from_numpy(x), levels, "9/7").numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    want_s = np.asarray(_jax_97(jdwt.synthesize, jnp.asarray(want), levels))
    got_s = dwt2d.synthesize(torch.from_numpy(want.copy()), levels,
                             "9/7").numpy()
    np.testing.assert_allclose(got_s, want_s, atol=1e-3, rtol=0)


def test_97_quantized_indices_match_jax():
    """trunc(c / delta) of the 9/7 coefficients: a float32 rounding
    difference can flip an index at a quantizer boundary; at most 0.01 %
    of the indices may differ."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (4, 144, 176)).astype(np.float32) - 128.0
    delta = np.float32(0.75)
    want = np.trunc(np.asarray(_jax_97(jdwt.analyze, jnp.asarray(x), 4))
                    / delta).astype(np.int32)
    got = torch.trunc(dwt2d.analyze(torch.from_numpy(x), 4, "9/7")
                      / torch.tensor(delta)).to(torch.int32).numpy()
    assert (got != want).mean() <= 1e-4, int((got != want).sum())


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 34, 46)])
def test_resample_matches_jax(shape):
    rng = np.random.default_rng(9)
    x = rng.integers(-40, 300, shape).astype(np.int16)
    np.testing.assert_array_equal(
        dwt2d.upsample2(torch.from_numpy(x)).numpy(),
        np.asarray(jdwt.upsample2(jnp.asarray(x))))
    np.testing.assert_array_equal(
        dwt2d.downsample2(torch.from_numpy(x)).numpy(),
        np.asarray(jdwt.downsample2(jnp.asarray(x))))


def test_downsample2_odd_dims_matches_jax():
    x = np.random.default_rng(10).integers(0, 256, (2, 17, 23)).astype(
        np.int32)
    np.testing.assert_array_equal(
        dwt2d.downsample2(torch.from_numpy(x)).numpy(),
        np.asarray(jdwt.downsample2(jnp.asarray(x))))


@pytest.mark.parametrize("bins,lo,hi", [(256, 0, 256), (256, 100, 140),
                                        (257, -3, 260)])
def test_histogram_entropy_matches_jax(bins, lo, hi):
    """float32 p*log2(p) sums in another order than XLA's: rtol 1e-6.
    Values outside [0, bins) are not counted, as in the JAX version."""
    rng = np.random.default_rng(bins + lo)
    vals = rng.integers(lo, hi, (3, 40, 52)).astype(np.int32)
    got = entropy.histogram_entropy_rows(torch.from_numpy(vals),
                                         bins).numpy()
    want = [float(jentropy.histogram_entropy(jnp.asarray(v), bins))
            for v in vals]
    np.testing.assert_allclose(got, want, rtol=1e-6)
