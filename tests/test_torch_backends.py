"""PyTorch port: the texture backends (codec/backends.py) and the J2K
code-stream writer (codec/j2k.py) against the JAX package (CPU).

The host backends (cp, zlib, j2k, mj2k, mjpeg) code the same integer
MCTF subbands with the same codecs, so their streams are byte-identical
to the JAX package's and each package decodes the other's stream as it
decodes its own.  ltw runs the float32 9/7 DWT on the device: there the
two encoders are held by bytes (1 %) and PSNR-Y (0.05 dB), as
tests/test_torch_api.py::test_lossy_close_to_jax holds the internal 9/7
path.  Pillow-dependent cases skip as the JAX package's tests skip."""

import io

import numpy as np
import pytest
import torch

from qsvc_tpu import api as japi
from qsvc_tpu.codec import backends as jbackends
from qsvc_tpu.codec import j2k as jj2k
from qsvc_tpu.codec.codestream import VideoStream as JaxStream
from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.io import synthetic_video, video_psnr
from qsvc_tpu_torch import api
from qsvc_tpu_torch.codec import backends, j2k
from qsvc_tpu_torch.codec.codestream import VideoStream
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.scal import extract

torch.set_num_threads(1)

#: backend -> quantization_texture of its case (tests/test_backends.py)
HOST_BACKENDS = {"cp": 45000, "zlib": 45000, "j2k": 45000, "mj2k": 44000,
                 "mjpeg": 43000}
LOSSLESS = ("cp", "zlib", "j2k")


def _kw(**kw):
    base = dict(pixels_in_x=64, pixels_in_y=48, TRLs=3, GOPs=1,
                block_size=16, search_range=2, SRLs=3,
                update_factor=0.0, quantization_texture=45000)
    base.update(kw)
    return base


def _cfg(**kw):
    return CodecConfig(**_kw(**kw))


@pytest.fixture(scope="module")
def vid():
    return synthetic_video(5, 48, 64, seed=7, kind="translate",
                           velocity=(1.0, 1.0))


def _needs(name):
    if name not in backends.available():
        pytest.skip(f"Pillow built without the codec of {name}")


@pytest.fixture(scope="module")
def encoded(vid):
    """{backend: (port bytes, JAX bytes)}, encoded once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = _kw(texture_backend=name,
                     quantization_texture=HOST_BACKENDS.get(name, 45000))
            cache[name] = (api.compress(vid, CodecConfig(**kw),
                                        device="cpu").to_bytes(),
                           japi.compress(vid, JaxConfig(**kw)).to_bytes())
        return cache[name]
    return get


def _planes_equal(a, b):
    for x, y, c in zip(a.planes(), b.planes(), "yuv"):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=c)


def test_registry_matches_jax():
    assert backends.available() == jbackends.available()


@pytest.mark.parametrize("name", sorted(HOST_BACKENDS))
def test_backend_streams_byte_identical(encoded, vid, name):
    _needs(name)
    tbytes, jbytes = encoded(name)
    assert tbytes == jbytes
    if name in LOSSLESS:
        _planes_equal(api.expand_bytes(tbytes, device="cpu"), vid)


@pytest.mark.parametrize("name", sorted(HOST_BACKENDS))
def test_backend_cross_decode(encoded, name):
    """Each package decodes the other's stream as it decodes its own."""
    _needs(name)
    tbytes, jbytes = encoded(name)
    _planes_equal(api.expand_bytes(jbytes, device="cpu"),
                  japi.expand_bytes(jbytes))
    _planes_equal(japi.expand_bytes(tbytes),
                  api.expand_bytes(tbytes, device="cpu"))


def test_ltw_close_to_jax(encoded, vid):
    tbytes, jbytes = encoded("ltw")
    assert abs(len(tbytes) - len(jbytes)) <= 0.01 * len(jbytes)
    p_t = video_psnr(vid, api.expand_bytes(tbytes, device="cpu"))[0]
    p_j = video_psnr(vid, japi.expand_bytes(jbytes))[0]
    assert abs(p_t - p_j) <= 0.05, (p_t, p_j)
    # cross decode: the other package's 9/7 synthesis of the same stream
    p_tj = video_psnr(vid, api.expand_bytes(jbytes, device="cpu"))[0]
    p_jt = video_psnr(vid, japi.expand_bytes(tbytes))[0]
    assert abs(p_tj - p_j) <= 0.05 and abs(p_jt - p_t) <= 0.05


# ------------------- the JAX package's backend tests, on the port's API

@pytest.mark.parametrize("name", ["cp", "zlib"])
def test_lossless_backend_roundtrip(vid, name):
    vs = api.compress(vid, _cfg(texture_backend=name), device="cpu")
    rec = api.expand(VideoStream.from_bytes(vs.to_bytes()), device="cpu")
    # update_factor=0 + lossless backend -> bit-exact through MCTF
    _planes_equal(rec, vid)


def test_zlib_smaller_than_cp(encoded):
    assert len(encoded("zlib")[0]) < len(encoded("cp")[0])


def test_j2k_backend_payloads_are_j2c(vid):
    _needs("j2k")
    vs = api.compress(vid, _cfg(texture_backend="j2k"), device="cpu")
    assert vs.low[0]["y"].payload[:2] == b"\xFF\x4F"


def test_mjpeg_backend_lossy_quality(encoded, vid):
    _needs("mjpeg")
    data = encoded("mjpeg")[0]
    vs = VideoStream.from_bytes(data)
    assert not vs.reversible
    assert len(data) < vid.y.size * 3 // 2
    assert video_psnr(vid, api.expand(vs, device="cpu"))[0] > 28
    assert vs.low[0]["y"].payload[:2] == b"\xff\xd8"


def test_backend_ts_extraction_works(vid):
    """TS extraction drops whole temporal levels — codec-agnostic, so it
    works on backend streams (QS/SS are internal-codec features)."""
    cfg = _cfg(texture_backend="zlib")
    vs = api.compress(vid, cfg, device="cpu")
    ts = extract.temporal_truncate(vs, 1)
    rec = api.expand(VideoStream.from_bytes(ts.to_bytes()), device="cpu")
    assert rec.frames == cfg.gop_size // 2 + 1
    np.testing.assert_array_equal(rec.y, vid.y[::2])


def test_backend_ss_extraction_rejected(vid):
    vs = api.compress(vid, _cfg(texture_backend="zlib"), device="cpu")
    with pytest.raises(ValueError, match="internal texture codec"):
        extract.spatial_truncate(vs, 1)
    with pytest.raises(ValueError, match="internal"):
        api._decode_plane_set(vs.low, discard_levels=1, device="cpu")


def test_unknown_backend_message():
    with pytest.raises(KeyError, match="available"):
        backends.get("kakadu")


def test_backend_streaming_gops():
    """compress_gops + expand_gops with a backend (host codec, no
    pipeline) keep the per-GOP container semantics, and equal JAX's."""
    vid = synthetic_video(9, 48, 64, seed=8, kind="translate",
                          velocity=(1.0, 1.0))
    kw = _kw(GOPs=2, texture_backend="zlib")
    streams = api.compress_gops(vid, CodecConfig(**kw), device="cpu")
    assert [s.to_bytes() for s in streams] == \
        [s.to_bytes() for s in japi.compress_gops(vid, JaxConfig(**kw))]
    _planes_equal(api.expand_gops(streams, device="cpu"), vid)


def test_backend_header_metadata(encoded):
    """Lossless backends mark reversible=True; lossy ones do not, and
    their delta is 0 (unused)."""
    assert VideoStream.from_bytes(encoded("cp")[0]).reversible
    vs = VideoStream.from_bytes(encoded("ltw")[0])
    assert not vs.reversible and vs.delta == 0.0


def test_ltw_backend_roundtrip_and_rate(vid):
    lo = api.compress(vid, _cfg(texture_backend="ltw",
                                quantization_texture=44000),
                      device="cpu").to_bytes()
    hi = api.compress(vid, _cfg(texture_backend="ltw",
                                quantization_texture=45500),
                      device="cpu").to_bytes()
    assert len(hi) < len(lo)            # higher slope -> fewer bytes
    rec = api.expand(VideoStream.from_bytes(lo), device="cpu")
    assert video_psnr(vid, rec)[0] > 30


def test_backend_frames_serialize_like_jax(encoded):
    """The tag-1 frame of the container reads back into the same
    fields in both packages."""
    tbytes, _ = encoded("zlib")
    t, j = VideoStream.from_bytes(tbytes), JaxStream.from_bytes(tbytes)
    for ft, fj in zip(t.low + t.levels[0].high, j.low + j.levels[0].high):
        for c in "yuv":
            assert (ft[c].backend, ft[c].H, ft[c].W, ft[c].payload) == \
                (fj[c].backend, fj[c].H, fj[c].W, fj[c].payload)


# ------------------------------------------------------------------ j2k

def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape
                                                ).astype(np.uint8)


def _smooth_noisy():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:128]
    return np.clip(128 + 60 * np.sin(xx / 9.0) + 50 * np.cos(yy / 7.0)
                   + rng.normal(0, 3, (96, 128)), 0, 255).astype(np.uint8)


J2K_CASES = {
    "53_levels0": ((64, 96), dict(levels=0, cb=32)),
    "53_levels3": ((64, 96), dict(levels=3, cb=32)),
    "53_odd_dims": ((67, 93), dict(levels=3, cb=32)),
    "53_many_codeblocks": ((128, 160), dict(levels=2, cb=32)),
    "97": (None, dict(levels=3, cb=32, reversible=False, base_delta=0.5)),
    "97_layered": (None, dict(levels=3, cb=32, reversible=False,
                              base_delta=0.125,
                              layer_slopes=[46500.0, 44000.0])),
    "53_layered": (None, dict(levels=3, cb=32,
                              layer_slopes=[45500.0, 0.0])),
}


@pytest.mark.parametrize("case", sorted(J2K_CASES))
def test_encode_j2c_matches_jax(case):
    shape, kw = J2K_CASES[case]
    img = _img(shape, sum(shape)) if shape else _smooth_noisy()
    assert j2k.encode_j2c(img, **kw) == jj2k.encode_j2c(img, **kw)


def test_j2c_decodes_with_openjpeg():
    """A lossless port stream through a third-party decoder."""
    pil = pytest.importorskip("PIL.Image")
    from PIL import features
    if not features.check("jpg_2000"):
        pytest.skip("Pillow built without OpenJPEG")
    img = _img((67, 93), 5)
    data = j2k.encode_j2c(img, levels=3, cb=32)
    np.testing.assert_array_equal(np.array(pil.open(io.BytesIO(data))), img)
