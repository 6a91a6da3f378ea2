"""PyTorch port: the device half of the texture codec against the JAX
package — bp R-D simulation, DWT+quantize+tiling, block selection, tile
scatter and decode."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qsvc_tpu.codec import bp_device as jbp
from qsvc_tpu.codec import frame_codec as jfc
from qsvc_tpu_torch.codec import bp_device, fast, frame_codec
from qsvc_tpu_torch.codec.frame_codec import slope_to_threshold

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_coder_source_is_the_jax_packages():
    """The port builds the EBCOT coder from its own copy of the C++
    source, which must stay byte-identical to the JAX package's: one
    stream format for both packages."""
    with open(os.path.join(ROOT, "qsvc_tpu", "native", "ebcot.cpp"),
              "rb") as f:
        want = f.read()
    with open(fast.SRC_PATH, "rb") as f:
        assert f.read() == want


def test_native_coder_builds_from_the_port():
    """Neither the source nor the library lies outside the port."""
    port = os.path.realpath(os.path.join(ROOT, "qsvc_tpu_torch"))
    for path in (fast.SRC_PATH, fast.SO_PATH):
        path = os.path.realpath(path)
        assert os.path.commonpath([path, port]) == port, path


def _tiles(rng, K=48, cb=64):
    scale = rng.choice([1, 8, 60, 900, 20000], size=(K, 1, 1))
    t = np.clip(np.round(rng.laplace(0, 1, (K, cb, cb)) * scale),
                -32768, 32767).astype(np.int16)
    t[::7] = 0                                      # some all-zero blocks
    th = rng.integers(1, cb + 1, K).astype(np.int32)
    tw = rng.integers(1, cb + 1, K).astype(np.int32)
    th[:K // 2] = cb
    tw[:K // 2] = cb
    return t, th, tw


def test_bp_max_slope_matches_jax(rng):
    """float32 SSE sums reduce in another order than XLA's (squares up to
    2^30 are not exact in float32): smax and d0 to rtol 1e-5."""
    t, th, tw = _tiles(rng)
    smax_j, d0_j = jbp.bp_max_slope(jnp.asarray(t), jnp.asarray(th),
                                    jnp.asarray(tw))
    smax, d0 = bp_device.bp_max_slope(*(torch.from_numpy(a)
                                        for a in (t, th, tw)))
    np.testing.assert_allclose(smax.numpy(), np.asarray(smax_j), rtol=1e-5)
    np.testing.assert_allclose(d0.numpy(), np.asarray(d0_j), rtol=1e-5)


@pytest.mark.parametrize("reversible,q", [(True, 46000), (False, 44000),
                                          (False, 45000)])
def test_dispatch_keep_masks_match_jax(reversible, q):
    """The blocks the encoder keeps: same keep mask, same compacted
    stack (ascending flat-index order), same int16 tiles.  The noise
    level rises across the plane, so some coded blocks fall below the
    threshold and some survive."""
    rng = np.random.default_rng(q)
    sigma = np.repeat([0.4, 3.0, 30.0], [30, 30, 28])
    planes = np.clip(128 + rng.normal(0, 1, (3, 72, 88)) * sigma, 0, 255
                     ).astype(np.int16)
    thr = np.full(3, slope_to_threshold(q))
    delta = 1.5 if not reversible else 0.125
    jp = jfc.encode_frames_dispatch_sparse(jnp.asarray(planes), 3,
                                           reversible, delta, 16, thr, "bp")
    tp = frame_codec.encode_frames_dispatch_sparse(
        torch.from_numpy(planes), 3, reversible, delta, 16, thr, "bp")
    keep_j, keep_t = np.asarray(jp[3]), tp[3].numpy()
    assert keep_t.any() and (~keep_t & (tp[2].numpy() > 0)).any()
    np.testing.assert_array_equal(keep_t, keep_j)
    k = int(keep_t.sum())
    np.testing.assert_array_equal(tp[1][:k].numpy(), np.asarray(jp[1])[:k])
    np.testing.assert_array_equal(tp[2].numpy(), np.asarray(jp[2]))


@pytest.mark.parametrize("shape,levels,cb", [((2, 80, 96), 2, 32),
                                             ((1, 72, 88), 3, 16)])
def test_dwt_quant_tiles_53_matches_jax(shape, levels, cb):
    rng = np.random.default_rng(levels)
    planes = rng.integers(0, 256, shape).astype(np.int16)
    d = np.float32(0.125)
    jt, jmax, _, jovf = jfc._dwt_quant_tiles(jnp.asarray(planes), levels,
                                             True, jnp.asarray(d), cb)
    tt, tmax, tovf = frame_codec._dwt_quant_tiles(
        torch.from_numpy(planes), levels, True, torch.tensor(d), cb)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(jmax))
    assert bool(tovf) == bool(jovf) is False


def test_scatter_tiles_overlapping_edge_tiles(rng):
    """Edge tiles' zero padding overlaps the neighbouring band (and runs
    past the plane): it must add 0, never overwrite."""
    N, H, W, cb = 2, 72, 88, 16
    tpl = frame_codec._tile_template(H, W, 2, cb)
    pos, tiles = [], []
    for n in range(N):
        for (b, ty, tx, th, tw, _g, _i) in tpl:
            t = np.zeros((cb, cb), np.int32)
            t[:th, :tw] = rng.integers(-99, 100, (th, tw))
            tiles.append(t)
            pos.append((n, b.y0 + ty, b.x0 + tx))
    tiles, pos = np.stack(tiles), np.asarray(pos, np.int32)
    want = np.asarray(jfc._scatter_tiles(jnp.asarray(tiles), jnp.asarray(pos),
                                         N, H, W))
    got = frame_codec._scatter_tiles(torch.from_numpy(tiles),
                                     torch.from_numpy(pos.astype(np.int64)),
                                     N, H, W).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) > 0.9 * N * H * W


@pytest.mark.parametrize("reversible,q,threshold", [
    (True, 0, 0.0),            # lossless: the dense branch
    (False, 45000, 0.0),       # lossy: the sparse branch
    (False, 44000, 4.0),       # sparse, extra decode-time truncation
])
def test_decode_frames_matches_jax(reversible, q, threshold):
    rng = np.random.default_rng(int(q))
    sigma = np.full((128, 128), 0.3)                # near-flat, but for
    sigma[96:, 96:] = 25.0                          # one textured corner
    planes = np.clip(128 + rng.normal(0, 1, (3, 128, 128)) * sigma, 0, 255
                     ).astype(np.uint8)
    efs = jfc.encode_frames(planes, 3, reversible,
                            0.125 if reversible else 1.0, 32,
                            slope_to_threshold(q) if q else 0.0, "bp")
    coded = sum(b.shape[0] * b.shape[1] for ef in efs for b in ef.blocks
                if b.data and (threshold <= 0
                               or b.passes_for_threshold(threshold)))
    assert (coded * 2 < planes.size) == (not reversible)   # which branch
    want = np.asarray(jfc.decode_frames(efs, threshold))
    got = frame_codec.decode_frames(efs, threshold, device="cpu")
    if reversible:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, planes)
    else:
        # the 9/7 synthesis rounds in float32: a pixel may land on the
        # other side of .5
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() <= 1e-3


def test_int16_overflow_takes_the_packed_path():
    """Coefficients past int16 (a tiny 9/7 step) re-run the transform in
    int32 and code the whole planes, as the JAX package does."""
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 256, (2, 64, 64)).astype(np.int16)
    planes[:, :32, :32] = 255
    delta, thr = 0.004, np.zeros(2)
    pend = frame_codec.encode_frames_dispatch_sparse(
        torch.from_numpy(planes), 3, False, delta, 32, thr, "bp")
    sel = frame_codec.encode_frames_select_sparse(pend, thr, "bp")
    assert sel[0] == "packed"
    efs = frame_codec.encode_frames_finish_sparse(sel, 64, 64, thr, "bp")
    jp = jfc.encode_frames_dispatch_sparse(jnp.asarray(planes), 3, False,
                                           delta, 32, thr, "bp")
    jsel = jfc.encode_frames_select_sparse(jp, thr, "bp")
    assert jsel[0] == "packed"
    jefs = jfc.encode_frames_finish_sparse(jsel, 64, 64, thr, "bp")
    got = frame_codec.decode_frames(efs, 0.0, device="cpu")
    want = np.asarray(jfc.decode_frames(jefs))
    assert np.abs(got - want).max() <= 1
    assert np.abs(got - planes).max() <= 1


@pytest.mark.parametrize("reversible,delta", [(True, 1.0), (False, 0.5)])
def test_dense_dispatch_fetch_matches_jax(reversible, delta):
    """The dense two-stage encode: int16 planes on the host.  The 5/3
    path is exact; a 9/7 index may flip at a quantizer boundary (float32
    rounding), at most 0.01 % of them."""
    planes = np.random.default_rng(5).integers(0, 256, (3, 36, 44)
                                               ).astype(np.uint8)
    got = frame_codec.encode_frames_fetch(frame_codec.encode_frames_dispatch(
        planes, 3, reversible, delta, device="cpu"))
    want = jfc.encode_frames_fetch(jfc.encode_frames_dispatch(
        planes, 3, reversible, delta))
    assert got.dtype == want.dtype == np.int16
    if reversible:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        assert (got != want).mean() <= 1e-4


def test_dense_fetch_takes_int32_on_overflow():
    """An index past int16 returns the whole stack as int32, exact on
    the 5/3 path (planes of 40000 overflow int16 after the level shift);
    a tensor input on the device is used in place."""
    planes = np.random.default_rng(6).integers(0, 256, (2, 32, 40)
                                               ).astype(np.int32)
    planes[0, :8, :8] = 40000
    pending = frame_codec.encode_frames_dispatch(
        torch.from_numpy(planes), 2, True, 1.0, device="cpu")
    got = frame_codec.encode_frames_fetch(pending)
    want = jfc.encode_frames_fetch(jfc.encode_frames_dispatch(
        planes, 2, True, 1.0))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 32767


def test_dense_dispatch_needs_a_device():
    """Without ``device`` the dense dispatch runs on the card: CUDA's
    error on a host without one, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the call would run on it")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        frame_codec.encode_frames_dispatch(np.zeros((1, 8, 8), np.uint8), 1,
                                           True, 1.0)
