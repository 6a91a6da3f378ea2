"""PyTorch port: scalable extraction, accounting, RD tools, the intra
anchor and resume (scal/, utils/artifacts.py) against the JAX package
(CPU).

Extraction is host code over the container: from one JAX-encoded stream
the port's QS/TS/SS/BRC extractions and ``transcode`` give the JAX
package's bytes, and ``format_table`` its text.  The SS-reduced decode
(``frame_codec.decode_frames(..., discard_levels)``, and ``api.expand``
of a spatially truncated stream) is integer on 5/3 and so exact; RD
points on a 9/7 stream come within 0.05 dB.  The resume store's key is
the JAX package's, so either package's store serves the other."""

import numpy as np
import pytest
import torch

from qsvc_tpu import api as japi
from qsvc_tpu.codec import frame_codec as jfc
from qsvc_tpu.codec.codestream import VideoStream as JaxStream
from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.scal import extract as jextract
from qsvc_tpu.scal import info as jinfo
from qsvc_tpu.scal import rd as jrd
from qsvc_tpu.utils import artifacts as jart
from qsvc_tpu_torch import api
from qsvc_tpu_torch.codec import frame_codec
from qsvc_tpu_torch.codec.codestream import VideoStream
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import Video
from qsvc_tpu_torch.scal import anchor, extract, info, rd
from qsvc_tpu_torch.utils.artifacts import (ArtifactStore,
                                            compress_gops_resumable, gop_key)

torch.set_num_threads(1)

# tests/test_extract.py's stream: 9/7, lossless (nothing truncated)
EXTRACT_KW = dict(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
                  block_size=16, search_range=4, update_factor=0.0,
                  quantization_texture=0, SRLs=3, nLayers=5)
# a reversible 5/3 MCTF stream with the update step on (integer end to end)
REV_KW = dict(pixels_in_x=96, pixels_in_y=80, TRLs=3, GOPs=1,
              block_size=16, search_range=4, update_factor=0.25,
              quantization_texture=0, SRLs=3)


@pytest.fixture(scope="module")
def jstream():
    """(video, JAX stream bytes) of tests/test_extract.py's encode."""
    cfg = JaxConfig(**EXTRACT_KW)
    vid = synthetic_video(cfg.pictures, 80, 96, seed=11)
    return vid, japi.compress(vid, cfg, reversible=False,
                              lossless=True).to_bytes()


@pytest.fixture(scope="module")
def rev_stream():
    """(video, JAX bytes, port bytes) of the reversible 5/3 stream."""
    vid = synthetic_video(5, 80, 96, seed=13, kind="translate")
    jbytes = japi.compress_bytes(vid, JaxConfig(**REV_KW))
    tbytes = api.compress_bytes(vid, CodecConfig(**REV_KW), device="cpu")
    assert tbytes == jbytes
    return vid, jbytes, tbytes


def _both(data):
    return VideoStream.from_bytes(data), JaxStream.from_bytes(data)


def _planes_equal(a, b):
    for x, y, c in zip(a.planes(), b.planes(), "yuv"):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=c)


# ------------------------------------------------------- extraction bytes

@pytest.mark.parametrize("quantization,clayers", [
    (45000.0, 0), (0.0, 1), (0.0, 3), (44000.0, 2)])
def test_quality_truncate_matches_jax(jstream, quantization, clayers):
    t, j = _both(jstream[1])
    assert extract.quality_truncate(t, quantization, clayers).to_bytes() \
        == jextract.quality_truncate(j, quantization, clayers).to_bytes()


@pytest.mark.parametrize("d", [1, 2])
def test_temporal_truncate_matches_jax(jstream, d):
    t, j = _both(jstream[1])
    assert extract.temporal_truncate(t, d).to_bytes() == \
        jextract.temporal_truncate(j, d).to_bytes()


@pytest.mark.parametrize("d", [1, 2])
def test_spatial_truncate_matches_jax(jstream, d):
    t, j = _both(jstream[1])
    assert extract.spatial_truncate(t, d).to_bytes() == \
        jextract.spatial_truncate(j, d).to_bytes()


@pytest.mark.parametrize("algorithm", ["FS", "PTS", "ITS", "PTL", "AmPTL",
                                       "SR", "ISR"])
def test_select_for_rate_matches_jax(jstream, algorithm):
    t, j = _both(jstream[1])
    budget = len(jstream[1]) // 3
    sel = extract.select_for_rate(t, budget, algorithm)
    assert sel.to_bytes() == \
        jextract.select_for_rate(j, budget, algorithm).to_bytes()
    coded = sum(sel.texture_bytes().values()) + \
        sum(sel.motion_bytes().values())
    assert coded <= budget * 1.05


@pytest.mark.parametrize("kw", [
    dict(quantization=45000.0, discard_TRLs=1),
    dict(clayers=2, discard_SRLs=1),
    dict(discard_TRLs=1, BRC=800.0, algorithm="FS"),
    dict(BRC=600.0, algorithm="ISR")], ids=["qs_ts", "clayers_ss",
                                            "ts_brc_fs", "brc_isr"])
def test_transcode_matches_jax(jstream, kw):
    t, j = _both(jstream[1])
    assert extract.transcode(t, **kw).to_bytes() == \
        jextract.transcode(j, **kw).to_bytes()


def test_format_table_matches_jax(jstream):
    t, j = _both(jstream[1])
    assert info.format_table(info.stream_info(t, 30.0)) == \
        jinfo.format_table(jinfo.stream_info(j, 30.0))


def test_stream_info_matches_jax():
    """The per-GOP table and the exact per-frame closure costs of
    tests/test_info.py's two-GOP all-B stream."""
    kw = dict(pixels_in_x=64, pixels_in_y=48, TRLs=3, GOPs=2, SRLs=3,
              block_size=16, search_range=2, quantization_texture=43000,
              always_B=True)
    vid = synthetic_video(9, 48, 64, seed=4)
    data = japi.compress(vid, JaxConfig(**kw), reversible=False).to_bytes()
    t, j = _both(data)
    st, sj = info.stream_info(t, 30.0), jinfo.stream_info(j, 30.0)
    assert st.gop_table() == [info.GOPRow(r.gop, r.L_kbps, r.subbands)
                              for r in sj.gop_table()]
    assert [st.frame_cost(n) for n in range(9)] == \
        [sj.frame_cost(n) for n in range(9)]
    assert st.frame_closure(3) == sj.frame_closure(3)


# ------------------------------------------------------- reduced decode

@pytest.fixture(scope="module")
def coded_frames():
    """Three 5/3 frames of one 80x96 plane stack, 3 DWT levels."""
    planes = synthetic_video(3, 80, 96, seed=17).y
    return frame_codec.encode_frames(planes, 3, True, 0.125, 16,
                                     coder="bp", device="cpu")


@pytest.mark.parametrize("d", [0, 1, 2, 3])
def test_reduced_decode_matches_decode_frames(coded_frames, d):
    """decode_frames at discard_levels d == the decode of the frames
    extraction reduced by d levels == the JAX package's, exactly."""
    got = frame_codec.decode_frames(coded_frames, discard_levels=d,
                                    device="cpu")
    reduced = [extract._reduce_frame(ef, d) for ef in coded_frames]
    np.testing.assert_array_equal(
        frame_codec.decode_frames(reduced, device="cpu"), got)
    np.testing.assert_array_equal(
        np.asarray(jfc.decode_frames(coded_frames, 0.0, d)), got)
    assert got.shape == (3, 80 >> d, 96 >> d)
    np.testing.assert_array_equal(
        frame_codec.decode_frame(coded_frames[1], discard_levels=d,
                                 device="cpu"), got[1])


def test_encode_frames_matches_jax():
    planes = synthetic_video(2, 48, 64, seed=3).u
    got = frame_codec.encode_frames(planes, 3, True, 0.125, 16,
                                    coder="mq", device="cpu")
    want = jfc.encode_frames(planes, 3, True, 0.125, 16, coder="mq")
    assert [[(b.data, b.pass_ends) for b in ef.blocks] for ef in got] == \
        [[(b.data, b.pass_ends) for b in ef.blocks] for ef in want]
    one = frame_codec.encode_frame(planes[1], 3, True, 0.125, 16,
                                   coder="mq", device="cpu")
    assert [b.data for b in one.blocks] == [b.data for b in got[1].blocks]


@pytest.mark.parametrize("d", [1, 2])
def test_ss_decode_matches_jax(rev_stream, d):
    """api.expand of a spatially truncated 5/3 stream (update step on:
    the MC kernels' blocks and vectors halve) equals the JAX decode."""
    vid, jbytes, _ = rev_stream
    t, j = _both(jbytes)
    got = api.expand(extract.spatial_truncate(t, d), device="cpu")
    _planes_equal(got, japi.expand(jextract.spatial_truncate(j, d)))
    assert got.y.shape == (5, 80 >> d, 96 >> d)


def test_ts_decode_matches_jax(rev_stream):
    vid, jbytes, _ = rev_stream
    t, j = _both(jbytes)
    _planes_equal(api.expand(extract.temporal_truncate(t, 1), device="cpu"),
                  japi.expand(jextract.temporal_truncate(j, 1)))


# ------------------------------------------------------------- RD tools

def test_rd_curve_matches_jax(jstream):
    """9/7 stream: the same truncations (bytes, kbps), PSNR within
    0.05 dB of the JAX decode."""
    vid, data = jstream
    t, j = _both(data)
    qs = [43000.0, 45000.0]
    got = rd.rd_curve(t, vid, qs, device="cpu")
    want = jrd.rd_curve(j, vid, qs)
    for g, w in zip(got, want):
        assert (g.quantization, g.bytes, g.kbps) == \
            (w.quantization, w.bytes, w.kbps)
        assert abs(g.psnr_y - w.psnr_y) <= 0.05, (g, w)
    assert "PSNR_Y" in rd.format_curve(got)


def test_rd_tools_exact_on_5_3(rev_stream):
    """Integer decode: rd_curve, rd_curve_gops and the slope search give
    the JAX package's points exactly."""
    vid, jbytes, _ = rev_stream
    t, j = _both(jbytes)
    qs = [44000.0, 45500.0]
    assert rd.rd_curve(t, vid, qs, device="cpu") == \
        [rd.RDPoint(**vars(p)) for p in jrd.rd_curve(j, vid, qs)]
    assert rd.rd_curve_gops([t], vid, qs, device="cpu") == \
        [rd.RDPoint(**vars(p)) for p in jrd.rd_curve_gops([j], vid, qs)]
    q, pt = rd.search_slope_for_distortion(t, vid, 2.0, tol=256.0,
                                           device="cpu")
    jq, jpt = jrd.search_slope_for_distortion(j, vid, 2.0, tol=256.0)
    assert (q, pt) == (jq, rd.RDPoint(**vars(jpt)))


def test_anchor_matches_jax():
    pytest.importorskip("PIL.Image")
    if not anchor.available():
        pytest.skip("Pillow built without OpenJPEG")
    from qsvc_tpu.scal import anchor as janchor
    vid = synthetic_video(2, 48, 64, seed=6)
    n, dec = anchor.encode_intra(vid, 4.0, levels=3)
    jn, jdec = janchor.encode_intra(vid, 4.0, levels=3)
    assert n == jn
    _planes_equal(dec, jdec)
    assert anchor.psnr_y(vid, dec) > 25


def test_mctf_beats_intra_at_matched_rate():
    """tests/test_rd_anchor.py's claim on the port's encode (bp coder)."""
    if not anchor.available():
        pytest.skip("Pillow built without OpenJPEG")
    cfg = CodecConfig(pixels_in_x=176, pixels_in_y=144, TRLs=3, GOPs=1,
                      block_size=16, search_range=4, SRLs=4,
                      quantization_texture=42000, nLayers=9,
                      update_factor=0.25)
    vid = synthetic_video(cfg.pictures, 144, 176, seed=5, kind="translate",
                          velocity=(1.0, 2.0))
    vs = api.compress(vid, cfg, reversible=False, device="cpu")
    (pt,) = rd.rd_curve(vs, vid, [44500.0], device="cpu")
    n_opj, dec_opj, _ = anchor.match_rate(vid, pt.bytes)
    assert n_opj <= pt.bytes * 1.05, (n_opj, pt.bytes)
    assert pt.psnr_y >= anchor.psnr_y(vid, dec_opj) + 0.5


# --------------------------------------------------------------- resume

@pytest.fixture(scope="module")
def small():
    kw = dict(pixels_in_x=32, pixels_in_y=32, TRLs=2, GOPs=3,
              block_size=16, search_range=2, update_factor=0.0,
              quantization_texture=0, SRLs=2)
    vid = synthetic_video(7, 32, 32, seed=19)
    return kw, vid


@pytest.mark.parametrize("change", [{}, dict(search_range=4),
                                    dict(texture_backend="zlib"),
                                    dict(quantization_texture=45000)])
@pytest.mark.parametrize("reversible", [True, False])
def test_gop_key_matches_jax(small, change, reversible):
    kw, vid = small
    kw = dict(kw, **change)
    chunk = vid[:3]
    key = gop_key(chunk, CodecConfig(**kw), reversible)
    assert key == jart.gop_key(chunk, JaxConfig(**kw), reversible)
    on_device = Video(*(torch.from_numpy(p) for p in chunk.planes()))
    assert gop_key(on_device, CodecConfig(**kw), reversible) == key


def test_resume_skips_cached_gops(tmp_path, small, monkeypatch):
    kw, vid = small
    cfg = CodecConfig(**kw)
    store = ArtifactStore(str(tmp_path / "cache"))
    streams1 = compress_gops_resumable(vid, cfg, store, reversible=True,
                                       device="cpu")
    assert len(streams1) == 3
    calls = []
    real = api.compress_dispatch

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(api, "compress_dispatch", counting)
    assert compress_gops_resumable(vid, cfg, store, reversible=True,
                                   device="cpu") == streams1
    assert calls == []
    # editing one GOP's frames re-encodes exactly that GOP
    vid2 = synthetic_video(7, 32, 32, seed=19)
    vid2.y[cfg.gop_size + 1] = np.clip(
        vid2.y[cfg.gop_size + 1].astype(np.int32) + 8, 0, 255
    ).astype(np.uint8)
    streams3 = compress_gops_resumable(vid2, cfg, store, reversible=True,
                                       device="cpu")
    assert len(calls) == 1
    assert streams3[0] == streams1[0] and streams3[2] == streams1[2]
    assert streams3[1] != streams1[1]
    rec = api.expand_gops([VideoStream.from_bytes(s) for s in streams3],
                          device="cpu")
    np.testing.assert_array_equal(rec.y, vid2.y)


def test_store_serves_both_packages(tmp_path, small, monkeypatch):
    """A store the JAX package wrote serves the port without an encode,
    and the port writes the JAX package's bytes under its keys."""
    kw, vid = small
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jblobs = jart.compress_gops_resumable(vid, JaxConfig(**kw),
                                          jart.ArtifactStore(jdir),
                                          reversible=True)
    monkeypatch.setattr(api, "compress_dispatch", None)   # must not run
    assert compress_gops_resumable(vid, CodecConfig(**kw),
                                   ArtifactStore(jdir), reversible=True,
                                   device="cpu") == jblobs
    monkeypatch.undo()
    assert compress_gops_resumable(vid, CodecConfig(**kw),
                                   ArtifactStore(tdir), reversible=True,
                                   device="cpu") == jblobs
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
