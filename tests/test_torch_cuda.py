"""PyTorch port: the CUDA kernels (K1 spiral SAD, K2 predict, K3 update,
K4 one-direction update) against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA device and skip without one;
``python3 chip_smoke.py`` runs the same comparisons at the flagship
shapes on the card.  The wrappers' argument checks run anywhere."""

import numpy as np
import pytest
import torch

from qsvc_tpu_torch.mctf import me, predict, update
from qsvc_tpu_torch.ops import cuda_lib, cuda_mc, cuda_me

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
        predict.predict_frame(*refs, mv, bs, 4 * sr), rtol=0, atol=0)
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
        predict.predict_frame(*refs, mv, bs, 4 * sr), rtol=0, atol=0)
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
        predict.predict_frame(*refs, mv, bs, 4 * sr), rtol=0, atol=0)


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


def test_k1_rejects_border():
    z = torch.zeros((1, 32, 32), dtype=torch.int16)
    mv = torch.zeros((1, 2, 2, 2, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        cuda_me.refine(z, z, z, mv, 16, 1, 32, 32, 4)


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
