"""PyTorch port: the MCTF temporal transform against the JAX package and
the reference goldens.  Integer throughout: exact."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.mctf import motion_coding as jmotion
from qsvc_tpu.mctf import transform as jtransform
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.mctf import me, motion_coding, transform

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "temporal_golden.npz")

CASES = {
    "96x80": dict(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
                  block_size=16, search_range=4, update_factor=0.25),
    "translate": dict(pixels_in_x=112, pixels_in_y=96, TRLs=3, GOPs=1,
                      block_size=16, search_range=8, update_factor=0.25),
}
# sub-pixel ME/MC (the update moves mv >> a), OLA alone and with
# sub-pixel, and a matching border: tests/test_subpixel.py's and
# tests/test_ola.py's configuration, update step on
_SMALL = dict(pixels_in_x=64, pixels_in_y=48, TRLs=3, GOPs=1, block_size=16,
              search_range=2, update_factor=0.25)
CASES.update({
    "subpixel_a1": dict(_SMALL, subpixel_accuracy=1),
    "subpixel_a2": dict(_SMALL, subpixel_accuracy=2),
    "subpixel_a3": dict(_SMALL, subpixel_accuracy=3),
    "ola_d4": dict(_SMALL, block_overlaping=4),
    "ola_d2_a1": dict(_SMALL, block_overlaping=2, subpixel_accuracy=1),
    "border2": dict(_SMALL, border_size=2),
})


def _arrays(stream):
    out = [stream.low_y, stream.low_u, stream.low_v]
    for lev in stream.levels:
        out += list(lev)
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = CASES[request.param]
    H, W = kw["pixels_in_y"], kw["pixels_in_x"]
    cfg = JaxConfig(**kw)
    vid = synthetic_video(cfg.pictures, H, W, seed=3,
                          kind="moving" if request.param == "96x80"
                          else "translate")
    jstream = jtransform.analyze_jit(jnp.asarray(vid.y), jnp.asarray(vid.u),
                                     jnp.asarray(vid.v), cfg)
    return kw, vid, jstream


def test_analyze_matches_jax(case):
    kw, vid, jstream = case
    got = transform.analyze(*(torch.from_numpy(p) for p in vid.planes()),
                            CodecConfig(**kw)).to_numpy()
    want = _arrays(jstream)
    have = _arrays(got)
    assert len(have) == len(want)
    for g, w in zip(have, want):
        np.testing.assert_array_equal(g, w)
    for lev_g, lev_w in zip(got.levels, jstream.levels):
        np.testing.assert_array_equal(lev_g.is_B, np.asarray(lev_w.is_B))


def test_synthesize_jax_stream_matches_jax(case):
    """MCTFStream.from_numpy of the JAX analysis, synthesized by the port,
    equals the JAX synthesis."""
    kw, vid, jstream = case
    want = jtransform.synthesize_jit(jstream, JaxConfig(**kw))
    got = transform.synthesize(
        transform.MCTFStream.from_numpy(jstream, device="cpu"),
        CodecConfig(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lossless_mctf_roundtrip():
    """update_factor = 0: the MCTF is exactly invertible."""
    cfg = CodecConfig(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
                      block_size=16, search_range=4, update_factor=0.0)
    vid = synthetic_video(cfg.pictures, 80, 96, seed=3)
    planes = [torch.from_numpy(p) for p in vid.planes()]
    rec = transform.synthesize(transform.analyze(*planes, cfg), cfg)
    for r, p in zip(rec, vid.planes()):
        np.testing.assert_array_equal(r.numpy(), p)


def test_motion_coding_matches_jax(rng):
    fields = [rng.integers(-9, 10, (4, 2, 2, 5, 6)).astype(np.int32),
              rng.integers(-9, 10, (2, 2, 2, 3, 3)).astype(np.int32),
              rng.integers(-9, 10, (1, 2, 2, 3, 3)).astype(np.int32)]
    want = jmotion.decorrelate([jnp.asarray(f) for f in fields])
    got = motion_coding.decorrelate([torch.from_numpy(f) for f in fields])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = motion_coding.correlate(got)
    for b, f in zip(back, fields):
        np.testing.assert_array_equal(b.numpy(), f)


# ---- reference C++ goldens (contract of tests/test_golden_temporal.py)

@pytest.fixture(scope="module")
def golden_level():
    g = np.load(GOLDEN)
    W, H, P, BLOCK, SR = (int(x) for x in g["meta"])
    cfg = CodecConfig(pixels_in_x=W, pixels_in_y=H, TRLs=2, GOPs=2,
                      block_size=BLOCK, search_range=SR, update_factor=0.25)
    planes = tuple(torch.from_numpy(g[c].astype(np.int16)) for c in "yuv")
    low, lev = transform._analyze_level(planes, BLOCK, SR, cfg)
    return g, (W, H, P, BLOCK, SR), low, lev


def test_golden_motion_vectors(golden_level):
    g, (W, H, P, BLOCK, SR), low, lev = golden_level
    y = torch.from_numpy(g["y"].astype(np.int16))
    mv = me.estimate_sequence(y[0::2], y[1::2], BLOCK, SR).numpy()
    np.testing.assert_array_equal(mv[:, :, :, 1:-1, 1:-1],
                                  g["motion"][:, :, :, 1:-1, 1:-1])
    assert int((mv != g["motion"]).sum()) <= 0.05 * mv.size


def test_golden_frame_types_and_high_bands(golden_level):
    g, _, low, lev = golden_level
    ft = np.where(lev.is_B.numpy(), ord("B"), ord("I")).astype(np.uint8)
    np.testing.assert_array_equal(ft, g["frame_types"])
    for name in ("high_y", "high_u", "high_v"):
        np.testing.assert_array_equal(getattr(lev, name).numpy(), g[name])


def test_golden_low_band_interior(golden_level):
    g, (W, H, P, BLOCK, SR), low, lev = golden_level
    for ours, name in zip(low, ("low_y", "low_u", "low_v")):
        o = ours.numpy().astype(np.int64)
        gg = g[name].astype(np.int64)
        b = SR
        np.testing.assert_array_equal(o[:, b:-b, b:-b], gg[:, b:-b, b:-b],
                                      err_msg=name)
        assert np.abs(o - gg).max() <= 32, name
