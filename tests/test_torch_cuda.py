"""PyTorch port: the CUDA kernels (K1 spiral SAD, K2 predict, K3 update,
K4 one-direction update, K5 the bp R-D simulation, K6 and K7 the 5/3
interpolation and decimation) against their plain PyTorch versions (K5
also against the native coder's pass records), and the captured programs
(``utils/graphs.py``) against their eager runs.

Tests marked ``gpu`` need a CUDA device and skip without one;
``python3 chip_smoke.py`` runs the same comparisons at the flagship
shapes on the card.  The wrappers' argument checks run anywhere."""

import collections
import concurrent.futures
import contextlib

import numpy as np
import pytest
import torch

from qsvc_tpu_torch import api
from qsvc_tpu_torch.codec import bp_device, fast, frame_codec
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.mctf import me, motion_coding, predict, transform, update
from qsvc_tpu_torch.ops import (cuda_bp, cuda_interp, cuda_lib, cuda_mc,
                                cuda_me, dwt2d)
from qsvc_tpu_torch.utils import graphs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, lo, hi, dtype, device):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)
                            ).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("P,ny,nx,By,Bx,bs,sr", [
    (2, 64, 128, 2, 4, 32, 4), (3, 40, 72, 3, 5, 16, 8),
    (1, 17, 30, 2, 2, 16, 32)])
def test_k1_matches_plain(cuda, P, ny, nx, By, Bx, bs, sr):
    rng = np.random.default_rng(ny)
    planes = [_rand(rng, (P, ny, nx), 0, 256, np.int16, cuda)
              for _ in range(3)]
    mv = _rand(rng, (P, 2, 2, By, Bx), -sr - 1, sr + 2, np.int32, cuda)
    got = me._refine_level_batch(*planes, mv, bs, 0, ny, nx, sr)
    want = me._refine_level(*planes, mv, bs, 0, ny, nx, sr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _k1_planes(rng, kind, shape, device):
    """Planes of 0..255 ("u8"), of the full int16 range ("int16": the
    kernel's wrap-around path) or of one value ("flat": every probe
    ties, so the spiral order decides)."""
    if kind == "flat":
        return [torch.full(shape, 77, dtype=torch.int16, device=device)
                for _ in range(3)]
    lo, hi = (0, 256) if kind == "u8" else (-2**15, 2**15)
    return [_rand(rng, shape, lo, hi, np.int16, device) for _ in range(3)]


def _k1_vectors(rng, P, By, Bx, sr, device):
    """|mv| <= sr + 1, every other block at +-(sr + 1)."""
    mv = rng.integers(-sr - 1, sr + 2, (P, 2, 2, By, Bx))
    edge = rng.choice([-sr - 1, sr + 1], mv.shape)
    mv[..., ::2] = edge[..., ::2]
    return torch.from_numpy(mv.astype(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["u8", "int16", "flat"])
@pytest.mark.parametrize("P", [1, 3, 8])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_k1_exact(cuda, bs, P, kind):
    """K1 == me._refine_level at every block size: a 3x4 block grid over
    planes of the grid's size whose active region is smaller and odd
    (a coarse pyramid depth), vectors up to +-(sr + 1) and at the
    edges."""
    rng = np.random.default_rng(bs * 10 + P)
    By, Bx, sr = 3, 4, max(2, bs // 2)
    ny, nx = 2 * bs + bs // 2 + 1, 3 * bs + 3
    planes = _k1_planes(rng, kind, (P, By * bs, Bx * bs), cuda)
    mv = _k1_vectors(rng, P, By, Bx, sr, cuda)
    got = cuda_me.refine(*planes, mv, bs, 0, ny, nx, sr)
    want = me._refine_level(*planes, mv, bs, 0, ny, nx, sr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["u8", "int16"])
@pytest.mark.parametrize("split", range(1, cuda_me.MAX_SPLIT + 1))
def test_k1_exact_at_each_split(cuda, split, kind):
    """Each cluster size: the CTAs of a block each sum their rows, rank 0
    adds them (level 4, depth 4 of the flagship: 2x2 blocks of 64)."""
    rng = np.random.default_rng(split)
    planes = _k1_planes(rng, kind, (1, 68, 120), cuda)
    mv = _k1_vectors(rng, 1, 2, 2, 32, cuda)
    got = cuda_me.refine(*planes, mv, 64, 0, 68, 120, 32, split=split)
    want = me._refine_level(*planes, mv, 64, 0, 68, 120, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["u8", "int16"])
@pytest.mark.parametrize("border", [1, 2, 3, 4])
@pytest.mark.parametrize("bs", [16, 64])
def test_k1_exact_border(cuda, bs, border, kind):
    """Windows widened by the border: the predicted window and both
    reference windows start `border` before the block, edge-replicated at
    the frame's edges (a 3x4 grid whose active region is smaller)."""
    rng = np.random.default_rng(bs + 10 * border)
    By, Bx, sr = 3, 4, 4
    ny, nx = 3 * bs - 5, 4 * bs - 3
    planes = _k1_planes(rng, kind, (2, By * bs, Bx * bs), cuda)
    mv = _k1_vectors(rng, 2, By, Bx, sr, cuda)
    got = cuda_me.refine(*planes, mv, bs, border, ny, nx, sr)
    want = me._refine_level(*planes, mv, bs, border, ny, nx, sr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("split", range(1, cuda_me.MAX_SPLIT + 1))
@pytest.mark.parametrize("kind", ["u8", "int16"])
@pytest.mark.parametrize("bs,border", [(128, 0), (256, 0), (512, 1),
                                       (1024, 2)])
def test_k1_exact_large_blocks(cuda, bs, border, kind, split):
    """The sub-pixel refinement's block sizes (block_size << s): windows
    walked in pieces of at most 256 columns, at each cluster size; the
    full int16 range takes the wrap path, and its window sums pass 2^31
    at win >= 256 and wrap as the plain version's int32 sums do."""
    rng = np.random.default_rng(bs + split)
    ny, nx = bs - 3, 2 * bs - 5
    planes = _k1_planes(rng, kind, (1, bs, 2 * bs), cuda)
    mv = _k1_vectors(rng, 1, 1, 2, 8, cuda)
    got = cuda_me.refine(*planes, mv, bs, border, ny, nx, 8, split=split)
    want = me._refine_level(*planes, mv, bs, border, ny, nx, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_k1_reads_mv_in_place_and_unaligned_planes(cuda):
    """A slice of a larger field, as estimate_sequence passes at coarse
    depths, is read through its strides; planes off the 16-byte grid and
    of odd width take the clamped loads."""
    rng = np.random.default_rng(11)
    P, By, Bx, bs, sr, ny, nx = 3, 3, 4, 16, 8, 37, 59
    field = _k1_vectors(rng, P, By + 2, Bx + 3, sr, cuda)
    mv = field[..., :By, :Bx]
    assert not mv.is_contiguous()
    planes = []
    for p in _k1_planes(rng, "u8", (P, ny, nx), cuda):
        flat = torch.empty(p.numel() + 1, dtype=p.dtype, device=cuda)
        view = flat[1:].view(p.shape)
        view.copy_(p)
        planes.append(view)
    want = me._refine_level(*planes, mv, bs, 0, ny, nx, sr)
    got = me._refine_level_batch(*planes, mv, bs, 0, ny, nx, sr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(cuda_me.refine(*planes, mv, bs, 0, ny, nx, sr),
                               want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,sr", [(16, 4), (16, 16), (8, 12)])
def test_k2_k3_match_plain(cuda, bs, sr):
    rng = np.random.default_rng(bs + sr)
    P, C, By, Bx = 2, 3, 4, 6
    H, W = By * bs, Bx * bs
    refs = [_rand(rng, (P, C, H, W), 0, 256, np.int16, cuda)
            for _ in range(2)]
    mv = _rand(rng, (P, 2, 2, By, Bx), -sr - 1, sr + 2, np.int32, cuda)
    torch.testing.assert_close(
        predict.predict_frames_batch(*refs, mv, bs, sr),
        predict.predict_frames_plain(*refs, mv, bs, 4 * sr), rtol=0, atol=0)
    res = _rand(rng, (P, C, H, W), -128, 128, np.int16, cuda)
    got = update.update_fields_batch2(res, mv, bs, 0.25, sr)
    for d in range(2):
        want = update._update_field(res, mv[:, d, 0], mv[:, d, 1], bs, 0.25,
                                    sr)
        torch.testing.assert_close(got[d], want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,sr", [(16, 4), (16, 16), (8, 12), (64, 32)])
def test_k4_matches_plain(cuda, bs, sr):
    """One direction, as the sharded MCTF calls it, |mv| up to sr + 1."""
    rng = np.random.default_rng(bs * 100 + sr)
    P, C, By, Bx = 3, 3, 3, 5
    H, W = By * bs, Bx * bs
    res = _rand(rng, (P, C, H, W), -128, 128, np.int16, cuda)
    mvy, mvx = (_rand(rng, (P, By, Bx), -sr - 1, sr + 2, np.int32, cuda)
                for _ in range(2))
    got = update.update_fields_batch(res, mvy, mvx, bs, 0.25, sr)
    want = update._update_field(res, mvy, mvx, bs, 0.25, sr)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _mc_inputs(rng, P, C, By, Bx, bs, sr, edge, device):
    H, W = By * bs, Bx * bs
    refs = [_rand(rng, (P, C, H, W), 0, 256, np.int16, device)
            for _ in range(2)]
    contrib = _rand(rng, (P, C, H, W), -128, 128, np.int16, device)
    if edge:                      # every block carries +-(sr + 1)
        mv = rng.choice([-sr - 1, sr + 1], (P, 2, 2, By, Bx))
        mv = torch.from_numpy(mv.astype(np.int32)).to(device)
    else:
        mv = _rand(rng, (P, 2, 2, By, Bx), -sr - 1, sr + 2, np.int32,
                   device)
    return refs, contrib, mv


def _assert_mc_exact(refs, contrib, mv, bs, sr):
    """K2, K3 and K4 equal their plain versions exactly, and K3's two
    directions equal two K4 launches on the same inputs."""
    torch.testing.assert_close(
        cuda_mc.predict(*refs, mv, bs, 4 * sr),
        predict.predict_frames_plain(*refs, mv, bs, 4 * sr), rtol=0, atol=0)
    k3 = cuda_mc.update2(contrib, mv, bs, sr)
    for d in range(2):
        my, mx = mv[:, d, 0].contiguous(), mv[:, d, 1].contiguous()
        k4 = cuda_mc.update1(contrib, my, mx, bs, sr)
        want = update._update_sums(contrib, my, mx, bs, sr)
        torch.testing.assert_close(k3[:, d], want, rtol=0, atol=0)
        torch.testing.assert_close(k4, want, rtol=0, atol=0)
        assert torch.equal(k3[:, d], k4)


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [False, True], ids=["random", "all_edge"])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_mc_kernels_exact(cuda, bs, K, P, edge):
    """K2, K3 and K4 at every block size the configurations produce, with
    K = ceil(sr / bs) neighbour blocks each way and |mv| up to sr + 1.
    One pair takes the smallest search range of that K (at bs 64, K 1:
    the flagship's level 1, sr 4), three pairs the largest."""
    sr = (K - 1) * bs + (max(1, bs // 16) if P == 1 else bs)
    assert -(-sr // bs) == K
    rng = np.random.default_rng(bs * 100 + K * 10 + P + 5 * edge)
    _assert_mc_exact(*_mc_inputs(rng, P, 3, K + 2, K + 3, bs, sr, edge,
                                 cuda), bs, sr)


@pytest.mark.gpu
@pytest.mark.parametrize("bs,sr,C", [(6, 5, 3), (12, 30, 1), (8, 33, 4)])
def test_mc_kernels_exact_off_the_fast_paths(cuda, bs, sr, C):
    """Block sizes off the 16-byte store width (element-wise tails), more
    neighbours than one pass of rectangles holds (bs 8, sr 33: K = 5),
    component counts other than 3, and references that are not 16-byte
    aligned (K2's clamped loads)."""
    rng = np.random.default_rng(bs + sr + C)
    refs, contrib, mv = _mc_inputs(rng, 2, C, 5, 6, bs, sr, False, cuda)
    _assert_mc_exact(refs, contrib, mv, bs, sr)
    shifted = []
    for r in refs:
        flat = torch.empty(r.numel() + 1, dtype=r.dtype, device=cuda)
        view = flat[1:].view(r.shape)
        view.copy_(r)
        shifted.append(view)
    torch.testing.assert_close(
        cuda_mc.predict(*shifted, mv, bs, 4 * sr),
        predict.predict_frames_plain(*refs, mv, bs, 4 * sr), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("edge", [False, True], ids=["random", "all_edge"])
@pytest.mark.parametrize("sr", [1, 2, 4, 8])
@pytest.mark.parametrize("bs", [4, 8])
def test_mc_kernels_exact_small_blocks(cuda, bs, sr, edge):
    """K2, K3 and K4 where a spatially reduced decode of the flagship
    runs them: discarding d = 4 (3) resolution levels of 1920x1088 with
    blocks of 64 leaves 8 pairs of 68x120 (136x240) frames in blocks of
    4 (8), at the search ranges 1, 2, 4 and 8 of its temporal levels.
    Blocks of 4 take K2's element-wise stores and clamped loads."""
    rng = np.random.default_rng(bs * 10 + sr + 100 * edge)
    _assert_mc_exact(*_mc_inputs(rng, 8, 3, 17, 30, bs, sr, edge, cuda),
                     bs, sr)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [128, 256, 512])
def test_k2_exact_large_blocks(cuda, bs):
    """K2 at the sub-pixel prediction's block_size << a, with the edge pad
    4 * (sr << a) and |mv| up to sr << a plus one."""
    rng = np.random.default_rng(bs)
    sr = bs // 16
    refs, _, mv = _mc_inputs(rng, 2, 3, 2, 3, bs, sr, False, cuda)
    torch.testing.assert_close(
        predict.predict_frames_batch(*refs, mv, bs, sr),
        predict.predict_frames_plain(*refs, mv, bs, 4 * sr), rtol=0, atol=0)


@pytest.mark.gpu
def test_launch_counts(cuda):
    cuda_lib.reset_launches()
    z = torch.zeros((1, 3, 32, 32), dtype=torch.int16, device=cuda)
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32, device=cuda)
    cuda_mc.predict(z, z, mv, 16, 16)
    cuda_mc.update2(z, mv, 16, 4)
    cuda_mc.update1(z, mv[:, 0, 0], mv[:, 0, 1], 16, 4)
    cuda_me.refine(z[:, 0], z[:, 0], z[:, 0], mv, 16, 0, 32, 32, 4)
    torch.cuda.synchronize()
    assert dict(cuda_lib.launches) == {"mc_predict": 1, "mc_update2": 1,
                                       "mc_update1": 1, "me_refine": 1}


def test_wrappers_reject_cpu_tensors():
    """A wrapper never computes on a tensor off the card."""
    z = torch.zeros((1, 3, 32, 32), dtype=torch.int16)
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mc.predict(z, z, mv, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mc.update2(z, mv, 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mc.update1(z, mv[:, 0, 0], mv[:, 0, 1], 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_me.refine(z[:, 0], z[:, 0], z[:, 0], mv, 16, 0, 32, 32, 4)


@pytest.mark.parametrize("split", [0, cuda_me.MAX_SPLIT + 1, 17])
def test_k1_rejects_bad_split(split):
    """1 to 8 CTAs per block, and no more than the block has rows (bs
    16: split 17 is past both)."""
    z = torch.zeros((1, 32, 32), dtype=torch.int16)
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="split"):
        cuda_me.refine(z, z, z, mv, 16, 0, 32, 32, 4, split=split)


@pytest.mark.parametrize("bs", [0])
def test_k1_rejects_block_size(bs):
    """Blocks of at least one pixel (any size above: the kernel walks a
    window in pieces)."""
    z = torch.zeros((1, 512, 512), dtype=torch.int16)
    mv = torch.zeros((1, 2, 2, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="block size"):
        cuda_me.refine(z, z, z, mv, bs, 0, 512, 512, 4)


def test_k1_rejects_negative_border():
    z = torch.zeros((1, 32, 32), dtype=torch.int16)
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="border"):
        cuda_me.refine(z, z, z, mv, 16, -1, 32, 32, 4)


def test_k1_rejects_too_many_pairs():
    """The grid's third dimension holds the pairs; shapes only (meta
    tensors), so the check runs before any device is touched."""
    P = cuda_me.MAX_PAIRS + 1
    planes = torch.empty((P, 16, 16), dtype=torch.int16, device="meta")
    mv = torch.empty((P, 2, 2, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="pairs"):
        cuda_me.refine(planes, planes, planes, mv, 16, 0, 16, 16, 4)


@pytest.mark.parametrize("n_blocks,bs,want", [
    (4080, 64, 1), (510, 64, 1), (135, 64, 1), (40, 64, 1), (24, 64, 1),
    (16, 64, 8), (12, 64, 8), (4, 64, 8), (1, 4, 4), (4080, 512, 1),
    (12, 1024, 8)])
def test_k1_auto_split(n_blocks, bs, want):
    """Clusters of 8 only where 8 CTAs per block still fit on the 132
    SMs, and never more CTAs than the block has rows; shared memory never
    asks for more (the sub-pixel calls' bs 128-512 and 1024 included)."""
    assert cuda_me.auto_split(n_blocks, bs, 132) == want


def test_k1_smem_layout():
    """int16 rows staged from a 16-byte aligned column: at bs 64 the block
    (64 x 72) and two windows (66 x 80) take 30,336 bytes, one piece; a
    split CTA owns ceil(64 / S) rows; a border widens the window (bs 64,
    border 2: 68 rows of 80 and 70 of 80); from 257 columns on the window
    splits into even tiles of at most 256, and past a CTA's 256 threads a
    piece holds 32 rows (bs 256: 32 x 264 and 34 x 272)."""
    assert cuda_me.smem_bytes(64, 1) == 2 * (64 * 72 + 2 * 66 * 80)
    assert cuda_me.smem_bytes(64, 3) == 2 * (22 * 72 + 2 * 24 * 80)
    assert cuda_me.smem_bytes(6, 1) == 2 * (6 * 16 + 2 * 8 * 16)
    assert cuda_me.smem_bytes(64, 1, 2) == 2 * (68 * 80 + 2 * 70 * 80)
    assert cuda_me.smem_bytes(256, 1) == 2 * (32 * 264 + 2 * 34 * 272)
    assert cuda_me.layout(64, 0, 1) == (64, 64, 64, 128)
    assert cuda_me.layout(128, 0, 1) == (128, 128, 64, 256)
    assert cuda_me.layout(512, 0, 1) == (512, 256, 32, 256)
    assert cuda_me.layout(1024, 2, 8) == (1028, 206, 32, 256)


@pytest.mark.parametrize("border", [0, 1, 4, 63])
def test_k1_smem_bounded(border):
    """Every block size up to 1024 at every split fits a CTA's 227 KB,
    and the worst case (bs 2 at border 63) takes 55,424 bytes."""
    most = max(cuda_me.smem_bytes(bs, s, border) for bs in range(1, 1025)
               for s in range(1, min(cuda_me.MAX_SPLIT, bs) + 1))
    assert most <= 55424 < 227 * 1024
    assert cuda_me.smem_bytes(2, 1, 63) == 55424


def test_predict_rejects_off_grid_frames():
    z = torch.zeros((1, 3, 30, 32), dtype=torch.int16)
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="grid"):
        cuda_mc.predict(z, z, mv, 16, 16)


def _mc_call(wrapper, planes, mv):
    if wrapper == "predict":
        return cuda_mc.predict(planes, planes, mv, 16, 16)
    if wrapper == "update2":
        return cuda_mc.update2(planes, mv, 16, 4)
    return cuda_mc.update1(planes, mv[:, 0, 0], mv[:, 0, 1], 16, 4)


@pytest.mark.parametrize("wrapper", ["predict", "update2", "update1"])
def test_mc_wrappers_reject_too_many_pairs(wrapper):
    """The kernels' grid holds at most MAX_PAIRS pairs; shapes only
    (meta tensors), so the check runs before any device is touched."""
    P = cuda_mc.MAX_PAIRS + 1
    planes = torch.empty((P, 3, 16, 16), dtype=torch.int16, device="meta")
    mv = torch.empty((P, 2, 2, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="pairs"):
        _mc_call(wrapper, planes, mv)


@pytest.mark.parametrize("wrapper", ["update2", "update1"])
def test_update_wrappers_reject_planes_past_int32(wrapper):
    """K3 and K4 index a plane with int32: 2^31 pixels are refused."""
    planes = torch.empty((1, 1, 32768, 65536), dtype=torch.int16,
                         device="meta")
    mv = torch.empty((1, 2, 2, 2048, 4096), dtype=torch.int32,
                     device="meta")
    with pytest.raises(ValueError, match="pixels"):
        _mc_call(wrapper, planes, mv)


# ---- captured programs: replay == eager, bit for bit

_GRAPH_CFG = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, GOPs=1,
                  block_size=16, search_range=4, update_factor=0.25)
GRAPH_CASES = {"whole-pixel": {}, "a=1": dict(subpixel_accuracy=1),
               "ola_d4": dict(block_overlaping=4),
               "border2": dict(border_size=2)}


def _video(device, seed, cfg):
    vid = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                          seed=seed, kind="translate")
    return [torch.from_numpy(p).to(device) for p in vid.planes()]


def _flat_stream(st):
    return [st.low_y, st.low_u, st.low_v] + [a for lev in st.levels
                                             for a in lev]


def _assert_same(got, want, label=""):
    got, want = list(got), list(want)
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), label


def _programs(planes, cfg):
    """Every captured program on one input, each with its eager run:
    ``[(name, replayed, eager)]``, the results as lists of tensors."""
    st = transform.analyze_jit(*planes, cfg)
    st_e = transform.analyze(*planes, cfg)
    rows = [("analyze", _flat_stream(st), _flat_stream(st_e))]
    for d in (0, 1):
        sub = st._replace(levels=st.levels[d:])
        rows.append((f"synthesize discard {d}",
                     transform.synthesize_jit(sub, cfg, d),
                     transform.synthesize(sub, cfg, d)))
    mvs = [lev.mv for lev in st.levels]
    res = motion_coding.decorrelate_jit(mvs)
    rows.append(("decorrelate", res, motion_coding.decorrelate(mvs)))
    rows.append(("correlate", motion_coding.correlate_jit(res),
                 motion_coding.correlate(res)))
    luma = torch.cat([st.low_y] + [lev.high_y for lev in st.levels])
    N, H, W = luma.shape
    nb = len(frame_codec._tile_template(H, W, 2, 16))
    for rev in (True, False):
        args = (luma, torch.tensor(1.5, device=luma.device),
                *frame_codec._tile_dims_on(H, W, 2, 16, N, luma.device),
                torch.full((N, nb), 0.5, device=luma.device), 2, rev, 16)
        rows.append((f"stage 1 rev={rev}",
                     frame_codec._encode_device_jit(*args),
                     frame_codec._encode_device(*args)))
        q = frame_codec._encode_device(*args)[0]          # any int32 stack
        q = q.reshape(-1)[:N * H * W].reshape(N, H, W).to(torch.int32)
        rows.append((f"dequant_idwt rev={rev}",
                     [frame_codec._dequant_idwt_jit(q, 2, rev, args[1])],
                     [frame_codec._dequant_idwt(q, 2, rev, args[1])]))
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_captured_programs_equal_eager(cuda, name):
    """analyze_jit, synthesize_jit (discard 0 and 1), decorrelate_jit,
    correlate_jit, stage 1 and _dequant_idwt: replay == eager, bit for
    bit, on the first call (which already replays) and on a second input
    through the graphs of the first (stale inputs would show)."""
    cfg = CodecConfig(**_GRAPH_CFG, **GRAPH_CASES[name])
    graphs.clear()
    for seed in (1, 2):
        for prog, got, want in _programs(_video(cuda, seed, cfg), cfg):
            _assert_same(got, want, prog)
        assert {g["replays"] for g in graphs.stats()} == {seed}


@pytest.mark.gpu
def test_captured_results_own_their_memory(cuda):
    """Aliasing: the first call's results are unchanged after the next
    replay of the same graph, and never share the graph's buffers."""
    cfg = CodecConfig(**_GRAPH_CFG)
    a = transform.analyze_jit(*_video(cuda, 1, cfg), cfg)
    keep = [t.clone() for t in _flat_stream(a)]
    b = transform.analyze_jit(*_video(cuda, 2, cfg), cfg)
    _assert_same(_flat_stream(a), keep)
    assert not torch.equal(a.levels[0].high_y, b.levels[0].high_y)
    ptrs = {t.data_ptr() for t in _flat_stream(b)}
    assert not ptrs & {t.data_ptr() for t in _flat_stream(a)}


@pytest.mark.gpu
def test_captured_programs_in_threads(cuda):
    """Four threads replay (and the first capture) the same and other
    graphs at once, as ``api.expand_gops`` does: each result equals its
    eager run."""
    cfg = CodecConfig(**_GRAPH_CFG)
    inputs = [_video(cuda, s, cfg) for s in range(4)]
    streams = [transform.analyze(*p, cfg) for p in inputs]
    want = [transform.synthesize(st, cfg) for st in streams]
    graphs.clear()

    def job(i):
        out = []
        for _ in range(3):
            out.append(transform.synthesize_jit(streams[i], cfg))
            out.append(transform.analyze_jit(*inputs[i], cfg))
        return out
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(job, range(4), timeout=600))
    for i, out in enumerate(results):
        for k in range(0, len(out), 2):
            _assert_same(out[k], want[i])
            _assert_same(_flat_stream(out[k + 1]),
                         _flat_stream(streams[i]))


@pytest.mark.gpu
def test_replay_counts_the_launches_of_the_eager_run(cuda):
    """A replay adds the kernels its capture recorded; the capture itself
    counts nothing."""
    cfg = CodecConfig(**_GRAPH_CFG)
    planes = _video(cuda, 1, cfg)
    st = transform.analyze(*planes, cfg)
    cuda_lib.reset_launches()
    transform.analyze(*planes, cfg)
    transform.synthesize(st, cfg)
    eager = collections.Counter(cuda_lib.launches)
    assert eager["me_refine"] and eager["mc_predict"] and eager["mc_update2"]
    graphs.clear()
    transform.analyze_jit(*planes, cfg)       # warm-up + capture + replay
    transform.synthesize_jit(st, cfg)
    cuda_lib.reset_launches()
    transform.analyze_jit(*planes, cfg)
    transform.synthesize_jit(st, cfg)
    assert collections.Counter(cuda_lib.launches) == eager
    names = {g["name"]: g["launches"] for g in graphs.stats()}
    assert names["analyze"]["me_refine"] == eager["me_refine"]


@pytest.mark.gpu
def test_captured_program_rejects_mixed_devices(cuda):
    fn = graphs.captured(lambda a, b: a + b)
    with pytest.raises(ValueError, match="one device"):
        fn(torch.zeros(1), torch.zeros(1, device=cuda))


# ---- K5: the bp R-D simulation

def _native_slope(tile):
    """(max prefix slope, d0) of the native bp coder's pass records for
    one un-padded tile."""
    cs = fast._bp_encode_tiles([tile.astype(np.int64)])[0]
    best = 0.0
    for end, d in zip(cs.pass_ends, cs.pass_dist):
        if end > 0:
            best = max(best, (cs.dist0 - d) / end)
    return best, cs.dist0


def _k5_case(name):
    """(tiles (K, cb, cb) int16, th, tw) of one case: the JAX package's
    bp_device test tiles, edge tiles whose padding holds noise (K5 must
    mask it), and blocks of 32 and 16."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("edge"):
        th, tw = map(int, name[4:].split("x"))
        tile = rng.integers(-500, 500, (1, 64, 64)).astype(np.int16)
        return tile, np.array([th], np.int32), np.array([tw], np.int32)
    if name.startswith("cb"):
        cb, K = int(name[2:]), 12
        scale = rng.choice([1, 8, 60, 900, 20000], size=(K, 1, 1))
        t = np.clip(np.round(rng.laplace(0, 1, (K, cb, cb)) * scale),
                    -32768, 32767).astype(np.int16)
        t[::5] = 0
        dims = rng.integers(1, cb + 1, (2, K)).astype(np.int32)
        dims[:, :K // 2] = cb
        return t, dims[0], dims[1]
    t = np.zeros((64, 64), np.int32)
    if name == "single":
        t[5, 7] = -3000
    elif name == "noise3":
        t = rng.integers(-3, 4, (64, 64))
    elif name == "dense2000":
        t = rng.integers(-2000, 2000, (64, 64))
    elif name == "sparse":
        t = (rng.normal(0, 30, (64, 64)) * (rng.random((64, 64)) < 0.05))
    elif name == "min":
        t[:] = -32768
    full = np.array([64], np.int32)
    return t.astype(np.int16)[None], full, full


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "zero", "single", "noise3", "dense2000", "sparse", "min",
    "edge64x17", "edge5x64", "edge9x13", "edge1x1", "cb32", "cb16"])
def test_k5_matches_native(cuda, name):
    """smax and d0 of K5 against the native bp coder run on each
    un-padded tile: smax to rel 1e-4, d0 to rel 1e-5."""
    tiles, th, tw = _k5_case(name)
    smax, d0 = cuda_bp.bp_slope(*(torch.from_numpy(a).to(cuda)
                                  for a in (tiles, th, tw)))
    smax, d0 = smax.cpu().numpy(), d0.cpu().numpy()
    for i, tile in enumerate(tiles):
        want_s, want_d = _native_slope(tile[:th[i], :tw[i]])
        assert smax[i] == pytest.approx(want_s, rel=1e-4, abs=1e-6), i
        assert d0[i] == pytest.approx(want_d, rel=1e-5), i


@pytest.fixture(scope="module")
def flagship_stacks():
    """The arguments of both ``_encode_device_jit`` calls (luma and chroma
    stack) of one flagship-size GOP of ``synthetic_video``, recorded
    during ``api.compress`` with fresh graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = CodecConfig(pixels_in_x=1920, pixels_in_y=1088, TRLs=5, GOPs=1,
                      SRLs=5, search_range=4, update_factor=0.25,
                      quantization_texture=45000)
    vid = synthetic_video(cfg.pictures, 1088, 1920, seed=0)
    calls = []
    original = frame_codec._encode_device_jit

    def record(*args):
        calls.append(args)
        return original(*args)
    graphs.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frame_codec, "_encode_device_jit", record)
        api.compress(vid, cfg, device="cuda")
    assert len(calls) == 2
    return calls


@pytest.mark.gpu
def test_k5_keeps_the_plain_blocks_on_a_flagship_gop(flagship_stacks):
    """K5 against the plain version on both stacks of a flagship GOP: the
    same keep mask at the config's slope floor, smax to rel 1e-5."""
    kept = []
    for planes, delta, th, tw, ms, levels, rev, cb in flagship_stacks:
        tiles, maxabs, _ = frame_codec._dwt_quant_tiles(planes, levels, rev,
                                                        delta, cb)
        flat = tiles.reshape(-1, cb, cb)
        got, _ = bp_device.bp_max_slope(flat, th, tw)
        want, _ = bp_device.bp_max_slope_plain(flat, th, tw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        keep = [(maxabs > 0) & (s.reshape(maxabs.shape) >= ms)
                for s in (got, want)]
        assert torch.equal(keep[0], keep[1])
        kept.append(keep[0].reshape(-1))
    kept = torch.cat(kept)            # the floor keeps some blocks, not all
    assert kept.any() and not kept.all()


@pytest.mark.gpu
def test_k5_in_the_captured_texture_program(flagship_stacks):
    """``_encode_device_jit`` replays equal its eager runs bit for bit at
    the flagship stacks, and each graph's record holds one K5 launch."""
    for args in flagship_stacks:
        _assert_same(frame_codec._encode_device_jit(*args),
                     frame_codec._encode_device(*args))
    recs = [g["launches"] for g in graphs.stats()
            if g["name"] == "_encode_device"]
    assert recs == [{"bp_slope": 1}] * 2


def test_bp_max_slope_takes_the_plain_version_on_the_cpu():
    """CPU tensors never reach K5: the plain version's values, exactly."""
    rng = np.random.default_rng(5)
    t = np.clip(np.round(rng.laplace(0, 40, (9, 16, 16))), -32768, 32767)
    args = (torch.from_numpy(t.astype(np.int16)),
            torch.from_numpy(rng.integers(1, 17, 9).astype(np.int32)),
            torch.full((9,), 16, dtype=torch.int32))
    cuda_lib.reset_launches()
    for got, want in zip(bp_device.bp_max_slope(*args),
                         bp_device.bp_max_slope_plain(*args)):
        assert torch.equal(got, want)
    assert not cuda_lib.launches


def _k5_args(fault):
    K, cb = 3, 16
    tiles = torch.zeros((K, cb, cb), dtype=torch.int16)
    dims = torch.full((K,), cb, dtype=torch.int32)
    th, tw, stripe = dims, dims, 4
    if fault == "int32 tiles":
        tiles = tiles.to(torch.int32)
    elif fault == "non-contiguous":
        tiles = torch.zeros((K, cb, 2 * cb), dtype=torch.int16)[:, :, ::2]
    elif fault == "cb 128":
        tiles = torch.zeros((K, 128, 128), dtype=torch.int16)
    elif fault == "cb 12":
        tiles = torch.zeros((K, 12, 12), dtype=torch.int16)
    elif fault == "th/tw lengths":
        tw = dims[:K - 1]
    elif fault == "stripe 8":
        stripe = 8
    return tiles, th, tw, stripe


@pytest.mark.parametrize("fault,match", [
    ("cpu", "CUDA"), ("int32 tiles", "int16"),
    ("non-contiguous", "contiguous"), ("cb 128", "code-block size"),
    ("cb 12", "code-block size"), ("th/tw lengths", "shape"),
    ("stripe 8", "stripe")])
def test_k5_rejects(fault, match):
    """The wrapper's argument checks raise before anything runs, each on
    its own fault (the device is checked last)."""
    tiles, th, tw, stripe = _k5_args(fault)
    with pytest.raises(ValueError, match=match):
        cuda_bp.bp_slope(tiles, th, tw, stripe)


# ---------------------------------------------------------------------------
# K6 and K7: the 5/3 interpolation and decimation
# ---------------------------------------------------------------------------

#: the cells' frame, and the pairs and search range of each temporal level
CELL_H, CELL_W = 1088, 1920
CELL_LEVELS = ((8, 4), (4, 8), (2, 16), (1, 32))


def _plain_interp(x, steps, up):
    return (dwt2d._interpolate_plain if up else dwt2d._decimate_plain)(
        x, steps)


def _card_int16(shape, seed, lo=-2**15, hi=2**15):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int16)


def _assert_interp_exact(xs, steps, up):
    got = (cuda_interp.upsample(xs, steps) if up else
           [cuda_interp.downsample(xs[0], steps)])
    assert len(got) == len(xs)
    for x, g in zip(xs, got):
        assert torch.equal(g, _plain_interp(x, steps, up))


def _cell_calls():
    """(label, up, input shapes, steps, chroma view) of every K6 and K7
    launch of the cells' MCTF at accuracies 0-3: per temporal level the
    motion search's steps (evens and odds), the prediction's 4:4:4
    interpolation and decimation, the chroma's 4:2:0 -> 4:4:4 (3-D
    stacks) and back (plane 1 of the 4:4:4 predictions, a view), and the
    motion search's LL pyramid."""
    H, W = CELL_H, CELL_W
    calls = []
    for P, sr in CELL_LEVELS:
        for s in (1, 2, 3):
            hw = (H << (s - 1), W << (s - 1))
            calls.append((f"me_up P={P} step {s}", True,
                          [(P + 1,) + hw, (P,) + hw], 1, False))
        for a in (1, 2, 3):
            calls.append((f"pred_up P={P} a={a}", True,
                          [(P + 1, 3, H, W)], a, False))
            calls.append((f"pred_down P={P} a={a}", False,
                          [(P, 3, H << a, W << a)], a, False))
        calls.append((f"chroma up P={P}", True,
                      [(P + 1, H // 2, W // 2)], 1, False))
        calls.append((f"chroma down P={P}", False, [(P, 3, H, W)], 1, True))
        for d in range(int(np.log2(sr)) - 1):
            calls.append((f"pyramid P={P} depth {d + 1}", False,
                          [(P + 1, H >> d, W >> d)], 1, False))
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("label,up,shapes,steps,view", _cell_calls(),
                         ids=[c[0] for c in _cell_calls()])
def test_interp_kernels_exact_at_the_cells_calls(cuda, label, up, shapes,
                                                 steps, view):
    """K6 and K7 == the plain closed forms at every call the cells make,
    over the full int16 range (so every wrap of the plain int16 sums)."""
    xs = [_card_int16(sh, i) for i, sh in enumerate(shapes)]
    if view:
        xs = [xs[0][:, 1]]
    _assert_interp_exact(xs, steps, up)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("H,W", [(1, 1), (3, 5), (17, 31), (5, 64),
                                 (33, 70), (70, 257)])
def test_interp_kernels_exact_at_small_and_odd_sizes(cuda, H, W, steps):
    """Odd frames for the interpolation (two stacks, one launch), odd
    outputs for the decimation, and rows too short or unaligned for the
    16-byte paths; 0..255 and full-range values."""
    for lo, hi in ((0, 256), (-2**15, 2**15)):
        _assert_interp_exact([_card_int16((2, H, W), 1, lo, hi),
                              _card_int16((3, H, W), 2, lo, hi)], steps,
                             True)
        _assert_interp_exact(
            [_card_int16((2, H << steps, W << steps), 3, lo, hi)], steps,
            False)


#: int16 values whose sums and differences wrap
WRAPPING = (-32768, -32767, -16385, -1, 0, 1, 16384, 32766, 32767)


@pytest.mark.gpu
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_interp_kernels_wrap_as_int16(cuda, steps):
    """Inputs drawn from values whose ``x + nxt``, ``so - ...`` and
    ``se + ...`` leave the int16 range, over several tiles and as views
    whose rows are not contiguous (the wrapper copies them)."""
    values = torch.tensor(WRAPPING, dtype=torch.int16, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(steps)
    pick = torch.randint(0, len(WRAPPING), (2, 3, 72, 600), generator=gen,
                         device=cuda)
    x = values[pick]
    assert ((x[..., 1:].int() + x[..., :-1].int()).abs() > 32767).any()
    _assert_interp_exact([x, x[:1, :2]], steps, True)
    _assert_interp_exact([x[..., ::2]], steps, True)
    _assert_interp_exact([x[..., :8 << steps, :64 << steps]], steps, False)
    big = values[torch.randint(0, len(WRAPPING), (2, 72 << steps,
                                                  600 << steps),
                               generator=gen, device=cuda)]
    _assert_interp_exact([big], steps, False)


def _subpel_regions(cfg, frames):
    """[(part, step, K6/K7 launches)] of each ``mctf.interp`` region of an
    eager analysis of ``frames`` on the card, the plain closed forms made
    to raise."""
    regions, span = [], dwt2d.interp_span

    def counted(part, xs, steps, *args, **kw):
        @contextlib.contextmanager
        def region():
            with span(part, xs, steps, *args, **kw):
                before = sum(cuda_lib.launches[k]
                             for k in ("interp_up", "interp_down"))
                yield
                n = sum(cuda_lib.launches[k]
                        for k in ("interp_up", "interp_down")) - before
            regions.append((part, kw.get("step"), n))
        return region()

    def plain(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain passes")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dwt2d, "interp_span", counted)
        mp.setattr(dwt2d, "_interp_axis", plain)
        mp.setattr(dwt2d, "_low_axis", plain)
        transform.analyze(*frames, cfg)
    return regions


@pytest.mark.gpu
def test_interp_one_launch_per_region_of_a_flagship_gop(cuda):
    """A quarter-pel analysis of one 1920x1088 GOP (4 temporal levels)
    opens 16 ``mctf.interp`` regions, each one launch of K6 or K7, and
    never reaches the plain passes."""
    cfg = CodecConfig(pixels_in_x=CELL_W, pixels_in_y=CELL_H, TRLs=5,
                      GOPs=1, SRLs=5, search_range=4, update_factor=0.25,
                      quantization_texture=45000, subpixel_accuracy=2)
    vid = synthetic_video(cfg.pictures, CELL_H, CELL_W, seed=0,
                          kind="translate", velocity=(1.25, 2.5))
    frames = [torch.from_numpy(p).to(cuda) for p in vid.planes()]
    regions = _subpel_regions(cfg, frames)
    parts = [(p, s) for p, s, _ in regions]
    assert parts == [("me_up", 1), ("me_up", 2), ("pred_up", None),
                     ("pred_down", None)] * 4
    assert [n for *_, n in regions] == [1] * 16


@pytest.mark.gpu
@pytest.mark.parametrize("a", [1, 2])
def test_subpel_encode_on_the_card_equals_the_reference(cuda, a):
    """The streamed quarter-pel encode on the card (K1-K7) gives the
    benchmark's plain reference's bytes, GOP for GOP, as
    ``tests/test_torch_subpel_stream.py`` holds on the CPU."""
    from benchmark.content import translate
    from benchmark.reference import encode as reference
    from benchmark.reference.config import CodecConfig as RefConfig
    from qsvc_tpu_torch.io.yuv import Video
    geometry = dict(pixels_in_x=256, pixels_in_y=128, TRLs=3, SRLs=3,
                    block_size=16, search_range=4)
    cfg = CodecConfig(**geometry, GOPs=2, subpixel_accuracy=a)
    S = cfg.gop_size
    y, u, v = translate.make(cfg.pictures, 128, 256, {
        "content_seed": 11, "velocity_y": 1.25, "velocity_x": 2.5}, "cpu")
    chunks = [Video(y, u, v)[g * S:(g + 1) * S + 1] for g in range(2)]
    cuda_lib.reset_launches()
    streams = [vs.to_bytes() for vs in api.compress_chunks(
        chunks, cfg.replace(GOPs=1), reversible=False, window=2,
        device="cuda")]
    assert cuda_lib.launches["interp_up"] and cuda_lib.launches[
        "interp_down"]
    rcfg = RefConfig(**geometry, GOPs=1, subpixel_accuracy=a)
    for chunk, data in zip(chunks, streams):
        assert reference.encode(chunk.y, chunk.u, chunk.v, rcfg,
                                "cpu") == data
