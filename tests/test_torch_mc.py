"""PyTorch port: motion-compensated predict and update against the JAX
package.

The plain versions of K2 (``predict.predict_frames_plain``) and K3
(``update._update_field``) against the Pallas kernels in interpret mode
and against the lax formulations, including the |mv| == block_size
extremes and vectors one past the update's padding.  Exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from qsvc_tpu.mctf import predict as jpredict
from qsvc_tpu.mctf import update as jupdate
from qsvc_tpu.ops import pallas_mc
from qsvc_tpu_torch.mctf import predict, update

torch.set_num_threads(1)

BS = 16
FX = pallas_mc._fx(BS)
H, W = 48, 128
BY, BX = H // BS, W // BS
P = 2
SR = 4


def _pad(x, bs, mode):
    fx = pallas_mc._fx(bs)
    return np.pad(x, [(0, 0), (0, 0), (bs, bs), (fx * bs, fx * bs)],
                  mode=mode)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _port_update2(res, mv, bs, sr):
    r, m = _t(res, mv)
    return [update._update_field(r, m[:, d, 0], m[:, d, 1], bs, 0.25,
                                 sr).numpy() for d in range(2)]


def _lax_update(res, mv, d, bs, sr):
    return np.asarray(jax.vmap(lambda r, my, mx: jupdate._update_field(
        r, my, mx, bs, 0.25, sr))(jnp.asarray(res), jnp.asarray(mv[:, d, 0]),
                                  jnp.asarray(mv[:, d, 1])))


def _refs_mv(rng, reach):
    refs = rng.integers(0, 256, (2, P, 3, H, W)).astype(np.int16)
    mv = rng.integers(-reach, reach + 1, (P, 2, 2, BY, BX)).astype(np.int32)
    return refs[0], refs[1], mv


def test_predict_plain_matches_pallas(rng):
    """|mv| up to the block size, the Pallas kernel's reach."""
    refs_p, refs_n, mv = _refs_mv(rng, BS)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_mc.predict_pallas(
            jnp.asarray(_pad(refs_p, BS, "edge")),
            jnp.asarray(_pad(refs_n, BS, "edge")), jnp.asarray(mv), BS))
    got = predict.predict_frames_plain(*_t(refs_p, refs_n, mv), BS,
                                       4 * SR).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reach", [SR, BS])
def test_predict_plain_matches_lax(rng, reach):
    refs_p, refs_n, mv = _refs_mv(rng, reach)
    lax = np.asarray(jax.vmap(lambda a, b, m: jpredict.predict_frame(
        a, b, m, BS, 4 * SR))(jnp.asarray(refs_p), jnp.asarray(refs_n),
                              jnp.asarray(mv)))
    got = predict.predict_frames_plain(*_t(refs_p, refs_n, mv), BS,
                                       4 * SR).numpy()
    np.testing.assert_array_equal(got, lax)


def test_predict_plain_beyond_border_matches_lax(rng):
    """Vectors past the edge padding: the lax gather moves its patch, the
    plain version (and K2) must move it the same way."""
    refs = rng.integers(0, 256, (2, P, 3, 32, 48)).astype(np.int16)
    mv = rng.integers(-7, 8, (P, 2, 2, 2, 3)).astype(np.int32)
    lax = np.asarray(jax.vmap(lambda a, b, m: jpredict.predict_frame(
        a, b, m, 16, 3))(jnp.asarray(refs[0]), jnp.asarray(refs[1]),
                         jnp.asarray(mv)))
    got = predict.predict_frames_plain(*_t(refs[0], refs[1], mv), 16,
                                       3).numpy()
    np.testing.assert_array_equal(got, lax)


def test_update_plain_matches_pallas_update2(rng):
    """Both directions, |mv| up to the block size (the Pallas kernel's
    reach), search_range = block size so the lax pad covers it too."""
    res = rng.integers(-128, 128, (P, 3, H, W)).astype(np.int16)
    mv = rng.integers(-BS, BS + 1, (P, 2, 2, BY, BX)).astype(np.int32)
    contrib = np.floor(res.astype(np.float32) * 0.25).astype(np.int16)
    mvp = np.pad(mv, [(0, 0), (0, 0), (0, 0), (1, 1), (1, 1)])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_mc.update2_pallas(
            jnp.asarray(_pad(contrib, BS, "constant")), jnp.asarray(mvp),
            BS))
    got = _port_update2(res, mv, BS, BS)
    np.testing.assert_array_equal(got[0], want[:, 0])
    np.testing.assert_array_equal(got[1], want[:, 1])


def test_update_plain_extreme_vectors(rng):
    """|mv| == block_size at the frame corners."""
    bs, h, w = 16, 32, 128
    res = rng.integers(-128, 128, (1, 1, h, w)).astype(np.int16)
    mv = np.where(rng.random((1, 2, 2, h // bs, w // bs)) < 0.5, -bs,
                  bs).astype(np.int32)
    got = _port_update2(res, mv, bs, bs)
    for d in range(2):
        np.testing.assert_array_equal(got[d], _lax_update(res, mv, d, bs, bs))


@pytest.mark.parametrize("bs,sr,reach", [(16, 4, 4), (16, 4, 5), (8, 12, 13),
                                         (16, 2, 9)])
def test_update_plain_matches_lax(rng, bs, sr, reach):
    """General K = ceil(sr/bs), and vectors past the search-range pad
    (motion estimation returns up to sr + 1) where the lax gather moves
    its patch."""
    h, w = 4 * bs, 6 * bs
    res = rng.integers(-128, 128, (P, 3, h, w)).astype(np.int16)
    mv = rng.integers(-reach, reach + 1, (P, 2, 2, 4, 6)).astype(np.int32)
    got = _port_update2(res, mv, bs, sr)
    for d in range(2):
        np.testing.assert_array_equal(got[d], _lax_update(res, mv, d, bs, sr))


def test_update_fields_batch2_cpu_matches_jax(rng):
    res = rng.integers(-128, 128, (P, 3, H, W)).astype(np.int16)
    mv = rng.integers(-SR - 1, SR + 2, (P, 2, 2, BY, BX)).astype(np.int32)
    want = jupdate.update_fields_batch2(jnp.asarray(res), jnp.asarray(mv),
                                        BS, 0.25, SR)
    got = update.update_fields_batch2(*_t(res, mv), BS, 0.25, SR)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_decorrelate_correlate_match_jax(rng):
    """Residues, I/B decision and the inverse, batched over pairs."""
    oy = rng.integers(0, 256, (P, 32, 48)).astype(np.int16)
    ou = rng.integers(0, 256, (P, 16, 24)).astype(np.int16)
    ov = rng.integers(0, 256, (P, 16, 24)).astype(np.int16)
    pred = np.clip(np.repeat(oy[:, None], 3, 1)
                   + rng.integers(-6, 7, (P, 3, 32, 48)), 0, 255
                   ).astype(np.int16)
    pred[1] = rng.integers(0, 256, (3, 32, 48))     # an I-frame candidate
    mv = rng.integers(-4, 5, (P, 2, 2, 2, 3)).astype(np.int32)
    want = jax.vmap(jpredict.decorrelate_from_pred)(
        (jnp.asarray(oy), jnp.asarray(ou), jnp.asarray(ov)),
        jnp.asarray(pred), jnp.asarray(mv))
    got = predict.decorrelate_from_preds(_t(oy, ou, ov), _t(pred)[0],
                                         _t(mv)[0])
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    back = predict.correlate_from_preds(got[:3], _t(pred)[0], got.is_B)
    want_back = jax.vmap(jpredict.correlate_from_pred)(
        tuple(want[:3]), jnp.asarray(pred), want.is_B)
    for g, w_ in zip(back, want_back):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _jax_ola(refs_p, refs_n, mv, bs, sr, d):
    return np.asarray(jpredict._predict_frames_ola(
        jnp.asarray(refs_p), jnp.asarray(refs_n), jnp.asarray(mv), bs, sr,
        d))


@pytest.mark.parametrize("bs,d", [(16, 2), (16, 4), (16, 8), (32, 16)])
def test_predict_frames_ola_matches_jax(rng, bs, d):
    """Overlapped-block prediction (decorrelate.cpp:69-189), from the
    smallest overlap to half the block, |mv| past the 4 * sr edge pad so
    the windows' lax starts move."""
    sr = 2
    refs = rng.integers(0, 256, (2, P, 3, 3 * bs, 4 * bs)).astype(np.int16)
    mv = rng.integers(-11, 12, (P, 2, 2, 3, 4)).astype(np.int32)
    got = predict.predict_frames_batch(*_t(refs[0], refs[1], mv), bs, sr,
                                       block_overlaping=d)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_ola(refs[0], refs[1], mv, bs, sr, d))


def test_predict_frames_ola_chunks_match_jax(rng, monkeypatch):
    """One block row per chunk (the sub-pixel windows' memory bound)
    stitches the same frame as one chunk."""
    monkeypatch.setattr(predict, "OLA_CHUNK", 1)
    refs = rng.integers(0, 256, (2, P, 3, 48, 64)).astype(np.int16)
    mv = rng.integers(-5, 6, (P, 2, 2, 3, 4)).astype(np.int32)
    got = predict.predict_frames_batch(*_t(refs[0], refs[1], mv), 16, 2,
                                       block_overlaping=4)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_ola(refs[0], refs[1], mv, 16, 2, 4))


@pytest.mark.parametrize("d", [0, 2])
@pytest.mark.parametrize("a", [1, 2, 3])
def test_predict_frames_subpixel_matches_jax(rng, a, d):
    """Sub-pixel prediction (decorrelate.cpp:656-686, 828-861), with and
    without OLA: the port interpolates the level's evens once and slices
    them, the JAX version each reference stack apart."""
    sr = 2
    evens = rng.integers(0, 256, (P + 1, 3, 48, 64)).astype(np.int16)
    reach = (sr << a) + 1
    mv = rng.integers(-reach, reach + 1, (P, 2, 2, 3, 4)).astype(np.int32)
    want = jpredict.predict_frames_subpixel(
        jnp.asarray(evens[:-1]), jnp.asarray(evens[1:]), jnp.asarray(mv),
        16, sr, a, d)
    got = predict.predict_frames_subpixel_evens(*_t(evens, mv), 16, sr, a,
                                                d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pair(rng, kind):
    """An (odd frame, 4:4:4 PREV/NEXT references, vectors) case of one
    pair at 48x64, blocks of 16: "near" predicts the odd frame closely
    (a B frame), "far" does not (an I frame candidate)."""
    from qsvc_tpu.io import synthetic_video
    vid = synthetic_video(3, 48, 64, seed=4, kind="translate")
    y, u, v = (p.astype(np.int16) for p in vid.planes())
    if kind == "far":
        y[1] = rng.integers(0, 256, y[1].shape)
    refs = [np.stack([y[i]] + [np.asarray(jpredict.upsample_chroma(
        jnp.asarray(c[i]))) for c in (u, v)]).astype(np.int16)
        for i in (0, 2)]
    mv = rng.integers(-3, 4, (2, 2, 3, 4)).astype(np.int32)
    return (y[1], u[1], v[1]), refs[0], refs[1], mv


@pytest.mark.parametrize("kind", ["near", "far"])
@pytest.mark.parametrize("d,always_B", [(0, False), (4, False), (0, True)])
def test_decorrelate_correlate_pair_match_jax(rng, kind, d, always_B):
    """The one-pair steps read the references edge-padded by
    4*search_range + block_overlaping (the plain version of K2), then
    form residues and the I/B decision; the inverse gives back what the
    JAX inverse does."""
    odd, rp, rn, mv = _pair(rng, kind)
    want = jpredict.decorrelate_pair(
        tuple(jnp.asarray(p) for p in odd), jnp.asarray(rp),
        jnp.asarray(rn), jnp.asarray(mv), 16, 1, d, always_B)
    got = predict.decorrelate_pair(_t(*odd), *_t(rp, rn, mv), 16, 1, d,
                                   always_B)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got.is_B.shape == ()
    back = predict.correlate_pair(got[:3], *_t(rp, rn), got.mv_out,
                                  got.is_B, 16, 1, d)
    want_back = jpredict.correlate_pair(tuple(want[:3]), jnp.asarray(rp),
                                        jnp.asarray(rn), want.mv_out,
                                        want.is_B, 16, 1, d)
    for g, w_ in zip(back, want_back):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    if kind == "near":
        for g, o in zip(back, odd):
            np.testing.assert_array_equal(g.numpy(), o)


@pytest.mark.parametrize("shape,bs,H_,W_", [((2, 2, 3, 4), 16, 48, 64),
                                            ((3, 5), 8, 37, 40),
                                            ((1, 1), 4, 4, 4)])
def test_mv_to_pixel_map_matches_jax(rng, shape, bs, H_, W_):
    mv = rng.integers(-9, 10, shape).astype(np.int32)
    got = predict.mv_to_pixel_map(torch.from_numpy(mv), bs, H_, W_)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpredict.mv_to_pixel_map(jnp.asarray(mv),
                                                         bs, H_, W_)))


def test_frame_planes_fields():
    assert predict.FramePlanes._fields == jpredict.FramePlanes._fields
