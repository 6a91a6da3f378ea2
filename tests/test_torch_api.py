"""PyTorch port: the codec API end to end against the JAX package (CPU).

Reversible configurations (those of tests/test_pipeline.py) must give
byte-identical streams, and each package must decode the other's stream
exactly as it decodes its own.  The lossy 9/7 path rounds in float32, so
there the two encoders are compared by bytes and PSNR."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qsvc_tpu import api as japi
from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.io import synthetic_video, video_psnr
from qsvc_tpu_torch import api
from qsvc_tpu_torch.codec.codestream import VideoStream
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.mctf.transform import MCTFStream

torch.set_num_threads(1)

REVERSIBLE = {
    # tests/test_pipeline.py::test_intra_lossless_bitexact
    "intra": (dict(pixels_in_x=176, pixels_in_y=144, TRLs=1, SRLs=3,
                   quantization_texture=0), 8, 2),
    # ::test_mctf_lossless_texture_roundtrip
    "mctf_lossless": (dict(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
                           block_size=16, search_range=4, update_factor=0.0,
                           quantization_texture=0, SRLs=3), 5, 3),
    # ::test_serialization_roundtrip (update step on)
    "mctf_update": (dict(pixels_in_x=96, pixels_in_y=80, TRLs=2, GOPs=1,
                         block_size=16, search_range=4, update_factor=0.25,
                         quantization_texture=0, SRLs=3), 3, 4),
    # tests/test_subpixel.py and tests/test_ola.py together: sub-pixel
    # a = 2 with OLA, lossless
    "subpixel_ola": (dict(pixels_in_x=64, pixels_in_y=48, TRLs=3, GOPs=1,
                          block_size=16, search_range=2, subpixel_accuracy=2,
                          block_overlaping=4, update_factor=0.0,
                          quantization_texture=0, SRLs=3), 5, 11),
}


def _planes_equal(a, b):
    for x, y, name in zip(a.planes(), b.planes(), "yuv"):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


@pytest.fixture(scope="module", params=sorted(REVERSIBLE))
def reversible_case(request):
    kw, frames, seed = REVERSIBLE[request.param]
    vid = synthetic_video(frames, kw["pixels_in_y"], kw["pixels_in_x"],
                          seed=seed)
    jbytes = japi.compress_bytes(vid, JaxConfig(**kw))
    tbytes = api.compress_bytes(vid, CodecConfig(**kw), device="cpu")
    return request.param, vid, jbytes, tbytes


def test_reversible_streams_byte_identical(reversible_case):
    name, vid, jbytes, tbytes = reversible_case
    assert tbytes == jbytes
    rec = api.expand_bytes(tbytes, device="cpu")
    if name != "mctf_update":            # lossless end to end
        _planes_equal(rec, vid)


def test_cross_decode_both_directions(reversible_case):
    name, vid, jbytes, tbytes = reversible_case
    _planes_equal(api.expand_bytes(jbytes, device="cpu"),
                  japi.expand_bytes(jbytes))
    _planes_equal(japi.expand_bytes(tbytes),
                  api.expand_bytes(tbytes, device="cpu"))


def test_padding_and_temporal_extraction_match_jax():
    """Input off the block grid and off the GOP length (padded, true
    geometry in the header), then a decode at half the frame rate."""
    kw = dict(pixels_in_x=88, pixels_in_y=72, TRLs=3, GOPs=1, block_size=16,
              search_range=4, update_factor=0.0, quantization_texture=0,
              SRLs=3)
    vid = synthetic_video(4, 70, 90, seed=7)
    jbytes = japi.compress_bytes(vid, JaxConfig(**kw))
    tbytes = api.compress_bytes(vid, CodecConfig(**kw), device="cpu")
    assert tbytes == jbytes
    _planes_equal(api.expand_bytes(tbytes, device="cpu"), vid)
    half = api.expand_bytes(tbytes, discard_TRLs=1, device="cpu")
    _planes_equal(half, japi.expand_bytes(jbytes, discard_TRLs=1))


def test_compress_gops_matches_jax():
    """Two GOPs through the pipelined chunk encoder, decoded back."""
    kw = dict(pixels_in_x=64, pixels_in_y=64, TRLs=2, block_size=16,
              search_range=4, update_factor=0.25, quantization_texture=0,
              SRLs=2)
    vid = synthetic_video(5, 64, 64, seed=9)
    jstreams = japi.compress_gops(vid, JaxConfig(**kw))
    tstreams = api.compress_gops(vid, CodecConfig(**kw), device="cpu")
    assert [s.to_bytes() for s in tstreams] == \
        [s.to_bytes() for s in jstreams]
    _planes_equal(api.expand_gops(tstreams, device="cpu"),
                  japi.expand_gops(jstreams))


def test_lossy_close_to_jax():
    """9/7 at slope 43000 (tests/test_pipeline.py::test_lossy_mctf_quality,
    bp coder).  The MCTF is integer and identical; the texture transform
    rounds in float32 in another order than XLA, which moves a few
    quantized coefficients: bytes within 1 %, PSNR-Y within 0.05 dB."""
    kw = dict(pixels_in_x=176, pixels_in_y=144, TRLs=3, GOPs=1,
              block_size=16, search_range=4, update_factor=0.25,
              quantization_texture=43000, SRLs=4)
    vid = synthetic_video(5, 144, 176, seed=5)
    jvs = japi.compress(vid, JaxConfig(**kw), reversible=False)
    tvs = api.compress(vid, CodecConfig(**kw), reversible=False,
                       device="cpu")
    jbytes, tbytes = jvs.to_bytes(), tvs.to_bytes()
    frames = [(f, g) for lj, lt in ([(jvs.low, tvs.low)] +
                                    [(a.high, b.high) for a, b in
                                     zip(jvs.levels, tvs.levels)])
              for f, g in zip(lj, lt)]
    pairs = [(bj, bt) for fj, ft in frames for c in "yuv"
             for bj, bt in zip(fj[c].blocks, ft[c].blocks)]
    differing = sum(bj.data != bt.data for bj, bt in pairs)
    print(f"lossy: {differing} of {len(pairs)} code-blocks differ; "
          f"{len(tbytes)} vs {len(jbytes)} bytes")
    assert abs(len(tbytes) - len(jbytes)) <= 0.01 * len(jbytes)
    py_t = video_psnr(vid, api.expand(VideoStream.from_bytes(tbytes),
                                      device="cpu"))[0]
    py_j = video_psnr(vid, japi.expand_bytes(jbytes))[0]
    assert abs(py_t - py_j) <= 0.05, (py_t, py_j)
    assert py_t > 28


def test_port_does_not_import_jax():
    code = ("import sys, qsvc_tpu_torch.api, qsvc_tpu_torch.mctf.transform, "
            "qsvc_tpu_torch.parallel.distributed, "
            "qsvc_tpu_torch.parallel.transform, qsvc_tpu_torch.cli, "
            "qsvc_tpu_torch.scal.extract, qsvc_tpu_torch.scal.info, "
            "qsvc_tpu_torch.scal.rd, qsvc_tpu_torch.scal.anchor, "
            "qsvc_tpu_torch.codec.backends, qsvc_tpu_torch.codec.j2k, "
            "qsvc_tpu_torch.utils.artifacts, qsvc_tpu_torch.ops.border, "
            "qsvc_tpu_torch.ops.lifting, qsvc_tpu_torch.mctf.me, "
            "qsvc_tpu_torch.mctf.predict, qsvc_tpu_torch.codec.mq, "
            "qsvc_tpu_torch.codec.tier1, qsvc_tpu_torch.codec.fast, "
            "qsvc_tpu_torch.parallel.scaling, qsvc_tpu_torch.tools.bench, "
            "qsvc_tpu_torch.tools.bench_decode, "
            "qsvc_tpu_torch.tools.rd_harness, qsvc_tpu_torch.tools.spread, "
            "qsvc_tpu_torch.tools.profile, "
            "qsvc_tpu_torch.tools.profile_stages, "
            "qsvc_tpu_torch.tools.profile_mctf, "
            "qsvc_tpu_torch.tools.profile_decode, "
            "qsvc_tpu_torch.tools.profile_pipeline, "
            "qsvc_tpu_torch.tools.profile_warmup, "
            "qsvc_tpu_torch.tools.profile_hbm, "
            "qsvc_tpu_torch.tools.profile_transfer, "
            "qsvc_tpu_torch.tools.profile_dispatch;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'qsvc_tpu.')) or m == 'qsvc_tpu'];"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_is_required():
    """Without ``device`` the entry points run on the card: on a host
    without one they raise CUDA's error, and nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the calls would run on it")
    vid = synthetic_video(1, 32, 32, seed=0)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        api.compress(vid, CodecConfig(pixels_in_x=32, pixels_in_y=32,
                                      TRLs=1))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        MCTFStream.from_numpy(MCTFStream(vid.y, vid.u, vid.v, ()))


def test_compress_chunks_hands_streams_to_progress_and_keeps_none():
    """With ``progress`` every stream goes to it, in order, and none is
    kept (the call returns an empty list), so a long feed holds only the
    GOPs in flight; the streams are those of a call without it."""
    from qsvc_tpu_torch.io import synthetic_video
    cfg = CodecConfig(pixels_in_x=64, pixels_in_y=64, TRLs=2, GOPs=3,
                      SRLs=2, block_size=16, search_range=4)
    video = synthetic_video(cfg.pictures, 64, 64, seed=2)
    S, gop_cfg = cfg.gop_size, cfg.replace(GOPs=1)
    chunks = [video[g * S:(g + 1) * S + 1] for g in range(cfg.GOPs)]
    kept = api.compress_chunks(chunks, gop_cfg, reversible=False,
                               device="cpu")
    got = []
    out = api.compress_chunks(
        iter(chunks), gop_cfg, reversible=False, window=2, device="cpu",
        progress=lambda i, vs: got.append((i, vs.to_bytes())))
    assert out == []
    assert got == [(i, vs.to_bytes()) for i, vs in enumerate(kept)]
