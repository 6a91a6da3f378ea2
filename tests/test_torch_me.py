"""PyTorch port: motion estimation against the JAX package.

K1's plain version (``me._refine_level``) against the Pallas kernel in
interpret mode and against the lax formulation; ``estimate_sequence``
end to end.  All integer: exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from qsvc_tpu.mctf import me as jme
from qsvc_tpu.ops import pallas_me
from qsvc_tpu_torch.mctf import me

torch.set_num_threads(1)

BS = 32
FX = pallas_me._fx(BS)
H, W = 64, 128
BY, BX = H // BS, W // BS
P = 2
SR = 4


def _pad(x, ny, nx):
    act = x[:, :ny, :nx].astype(np.int32)
    return np.pad(act, ((0, 0), (BS, BY * BS + BS - ny),
                        (FX * BS, BX * BS + FX * BS - nx)), mode="edge")


def _planes(rng, ny, nx):
    return [rng.integers(0, 256, (P, ny, nx)).astype(np.int16)
            for _ in range(3)]


def _port(planes, mv, ny, nx, max_mv, bs=BS):
    t = [torch.from_numpy(p) for p in planes]
    return me._refine_level(*t, torch.from_numpy(mv), bs, 0, ny, nx,
                            max_mv).numpy()


@pytest.mark.parametrize("seed,shrink", [(0, (0, 0)), (1, (0, 0)),
                                         (3, (10, 20))])
def test_refine_plain_matches_pallas_interpret(seed, shrink):
    """Active region = the block grid, and smaller than it (coarse
    pyramid depths): clamped reads equal the Pallas kernel's
    edge-padded windows."""
    rng = np.random.default_rng(seed)
    ny, nx = H - shrink[0], W - shrink[1]
    planes = _planes(rng, ny, nx)
    mv = rng.integers(-SR, SR + 1, (P, 2, 2, BY, BX)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        d = np.asarray(pallas_me.refine_pallas(
            *(jnp.asarray(_pad(p, ny, nx)) for p in planes),
            jnp.asarray(mv), BS))[..., :BX]
    want = mv + d.reshape(P, 2, 2, BY, BX)
    np.testing.assert_array_equal(_port(planes, mv, ny, nx, SR), want)


@pytest.mark.parametrize("bs,ny,nx,max_mv,reach", [
    (32, 64, 128, 4, 4),      # the main-path regime
    (16, 40, 56, 3, 6),       # |mv| beyond max_mv: the gather start clamps
    (16, 48, 48, 2, 1),       # coarse depth: active region < block grid
])
def test_refine_plain_matches_lax(bs, ny, nx, max_mv, reach):
    rng = np.random.default_rng(bs + ny)
    By, Bx = -(-ny // bs) + 1, -(-nx // bs)
    planes = _planes(rng, ny, nx)
    mv = rng.integers(-reach, reach + 1, (P, 2, 2, By, Bx)).astype(np.int32)
    want = jax.vmap(lambda a, b, c, m: jme._refine_level(
        a, b, c, m, bs, 0, ny, nx, max_mv))(
        *(jnp.asarray(p) for p in planes), jnp.asarray(mv))
    np.testing.assert_array_equal(_port(planes, mv, ny, nx, max_mv, bs),
                                  np.asarray(want))


@pytest.mark.parametrize("kind", ["int16", "flat", "two_values"])
def test_refine_plain_matches_lax_wrap_and_ties(kind):
    """The semantics K1 keeps: over the full int16 range the per-pixel
    |a - b| wraps in int16 (and |-32768| stays negative) before the int32
    sums; on flat or two-valued planes most probes tie and the spiral
    order (later probe wins, (0,0) last) decides."""
    rng = np.random.default_rng({"int16": 21, "flat": 22,
                                 "two_values": 23}[kind])
    bs, ny, nx, max_mv = 16, 40, 56, 4
    By, Bx = -(-ny // bs), -(-nx // bs)
    if kind == "int16":
        planes = [rng.integers(-2**15, 2**15, (P, ny, nx)).astype(np.int16)
                  for _ in range(3)]
        planes[0][:, :4, :4] = -2**15           # |(-32768) - 0| wraps
        planes[1][:, :8, :8] = 0
    elif kind == "flat":
        planes = [np.full((P, ny, nx), 77, np.int16) for _ in range(3)]
    else:
        planes = [rng.choice([3, 9], (P, ny, nx)).astype(np.int16)
                  for _ in range(3)]
    mv = rng.integers(-max_mv - 1, max_mv + 2,
                      (P, 2, 2, By, Bx)).astype(np.int32)
    want = jax.vmap(lambda a, b, c, m: jme._refine_level(
        a, b, c, m, bs, 0, ny, nx, max_mv))(
        *(jnp.asarray(p) for p in planes), jnp.asarray(mv))
    np.testing.assert_array_equal(_port(planes, mv, ny, nx, max_mv, bs),
                                  np.asarray(want))


def test_refine_plain_border_matches_lax():
    """border_size > 0: each block is matched over its window widened by
    the border (K1 computes the same on the card)."""
    rng = np.random.default_rng(5)
    planes = _planes(rng, 48, 64)
    mv = rng.integers(-2, 3, (P, 2, 2, 3, 4)).astype(np.int32)
    want = jax.vmap(lambda a, b, c, m: jme._refine_level(
        a, b, c, m, 16, 2, 48, 64, 2))(
        *(jnp.asarray(p) for p in planes), jnp.asarray(mv))
    got = me._refine_level(*(torch.from_numpy(p) for p in planes),
                           torch.from_numpy(mv), 16, 2, 48, 64, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("H_,W_,bs,sr,kind", [
    (64, 96, 16, 4, "moving"), (96, 128, 32, 16, "translate"),
    (80, 112, 16, 8, "random")])
def test_estimate_sequence_matches_jax(H_, W_, bs, sr, kind):
    from qsvc_tpu.io import synthetic_video
    vid = synthetic_video(5, H_, W_, seed=sr, kind=kind)
    y = vid.y.astype(np.int16)
    want = jme.estimate_sequence(jnp.asarray(y[0::2]), jnp.asarray(y[1::2]),
                                 bs, sr, 0, 0)
    got = me.estimate_sequence(torch.from_numpy(y[0::2]),
                               torch.from_numpy(y[1::2]), bs, sr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lax_refine(planes, mv, bs, border, ny, nx, max_mv):
    return np.asarray(jax.vmap(lambda a, b, c, m: jme._refine_level(
        a, b, c, m, bs, border, ny, nx, max_mv))(
        *(jnp.asarray(p) for p in planes), jnp.asarray(mv)))


def _port_refine(planes, mv, bs, border, ny, nx, max_mv):
    return me._refine_level(*(torch.from_numpy(p) for p in planes),
                            torch.from_numpy(mv), bs, border, ny, nx,
                            max_mv).numpy()


@pytest.mark.parametrize("border", [1, 2, 3, 4])
@pytest.mark.parametrize("bs", [8, 16])
def test_k1_border_parity(bs, border):
    """K1's plain version at every border the card tests (it raised on
    the card before K1 took borders): active region smaller than the
    grid, vectors up to max_mv + 1, against the lax formulation."""
    rng = np.random.default_rng(bs * 10 + border)
    ny, nx = 3 * bs - 3, 4 * bs - 5
    planes = [rng.integers(0, 256, (P, 3 * bs, 4 * bs)).astype(np.int16)
              for _ in range(3)]
    mv = rng.integers(-4, 5, (P, 2, 2, 3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        _port_refine(planes, mv, bs, border, ny, nx, 3),
        _lax_refine(planes, mv, bs, border, ny, nx, 3))


@pytest.mark.parametrize("bs,border,kind", [
    (128, 0, "u8"), (256, 1, "u8"), (256, 1, "wrap"), (512, 0, "wrap")])
def test_refine_plain_large_blocks_match_lax(bs, border, kind):
    """Block sizes K1 refused before (a thread owned one column, up to
    256): the sub-pixel refinement calls it at block_size << s.  "wrap":
    the predicted frame at 32767 against references near 0, so a window
    sum of (bs + 2 border)^2 terms passes 2^31 and wraps; the plain
    version's int32 sum wraps as the lax sum does (and as K1's int32
    adds do)."""
    rng = np.random.default_rng(bs + border)
    n = bs + bs // 2
    if kind == "u8":
        planes = [rng.integers(0, 256, (1, n, n)).astype(np.int16)
                  for _ in range(3)]
    else:
        planes = [np.full((1, n, n), 32767, np.int16)] + [
            rng.integers(0, 12, (1, n, n)).astype(np.int16)
            for _ in range(2)]
        assert (bs + 2 * border) ** 2 * 32755 > 2**31
    mv = rng.integers(-5, 6, (1, 2, 2, 1, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        _port_refine(planes, mv, bs, border, n, n, 4),
        _lax_refine(planes, mv, bs, border, n, n, 4))


@pytest.mark.parametrize("border", [0, 2])
@pytest.mark.parametrize("a", [1, 2, 3])
@pytest.mark.parametrize("H_,W_,bs,sr", [(48, 64, 16, 2), (80, 96, 16, 4)])
def test_estimate_sequence_subpixel_matches_jax(H_, W_, bs, sr, a, border):
    """Sub-pixel motion estimation (motion_estimate.cpp:361-407) at the
    shapes of tests/test_subpixel.py, and a larger search range: the
    refinement at block_size << s on frames interpolated a times, with
    the border halved per step."""
    from qsvc_tpu.io import synthetic_video
    vid = synthetic_video(5, H_, W_, seed=sr, kind="translate")
    y = vid.y.astype(np.int16)
    want = jme.estimate_sequence(jnp.asarray(y[0::2]), jnp.asarray(y[1::2]),
                                 bs, sr, border, a)
    got = me.estimate_sequence(torch.from_numpy(y[0::2]),
                               torch.from_numpy(y[1::2]), bs, sr, border, a)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("H_,W_,bs,sr,a,kind", [
    (64, 96, 16, 4, 0, "moving"), (96, 128, 32, 16, 0, "translate"),
    (48, 64, 16, 4, 1, "translate"), (32, 64, 16, 2, 2, "random")])
def test_estimate_pair_matches_jax(H_, W_, bs, sr, a, kind):
    """One (even, odd, even) triple, whole-pixel and sub-pixel."""
    from qsvc_tpu.io import synthetic_video
    y = synthetic_video(3, H_, W_, seed=sr + a, kind=kind).y.astype(np.int16)
    want = jme.estimate_pair(*(jnp.asarray(y[i]) for i in (1, 0, 2)), bs,
                             sr, 0, a)
    got = me.estimate_pair(*(torch.from_numpy(y[i]) for i in (1, 0, 2)), bs,
                           sr, 0, a)
    assert got.shape == (2, 2, H_ // bs, W_ // bs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
