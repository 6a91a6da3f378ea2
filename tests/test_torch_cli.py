"""PyTorch port: the CLI (``python -m qsvc_tpu_torch.cli``) and the
YUV/VIX file I/O against the JAX package (CPU).

Every command runs through ``cli.main`` the way a user runs it, with
``--device cpu``.  Lossless ``compress`` output files (streaming,
whole-sequence, resumed, and through a host texture backend) equal the
JAX CLI's byte for byte, and so do ``transcode`` outputs; ``--device
cuda`` on a host without a card raises instead of falling back."""

import os

import numpy as np
import pytest
import torch

from qsvc_tpu import cli as jcli
from qsvc_tpu.io import yuv as jyuv
from qsvc_tpu_torch import cli
from qsvc_tpu_torch.codec import codestream
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.io.yuv import (parse_geometry, read_vix, read_yuv,
                                   vix_to_raw, write_yuv)

torch.set_num_threads(1)

# tests/test_cli.py's geometry; update_factor 0 so --lossless round trips
# are bit-exact
ARGS = ["--pixels_in_x", "64", "--pixels_in_y", "48", "--TRLs", "3",
        "--SRLs", "3", "--block_size", "16", "--search_range", "2",
        "--update_factor", "0"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def yuv_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    vid = synthetic_video(13, 48, 64, seed=23, kind="translate",
                          velocity=(1.0, 1.0))
    p = str(d / "in.yuv")
    write_yuv(p, vid)
    return p, vid


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _compress_both(tmp_path, args):
    """(port file bytes, JAX file bytes) of one compress command."""
    tout, jout = str(tmp_path / "t.qsvc"), str(tmp_path / "j.qsvc")
    assert cli.main(["compress", "--output", tout] + args + CPU) == 0
    assert jcli.main(["compress", "--output", jout] + args) == 0
    return _read(tout), _read(jout)


@pytest.mark.parametrize("mode", [[], ["--whole_sequence"],
                                  ["--texture_backend", "zlib"]],
                         ids=["streaming", "whole_sequence", "zlib"])
def test_lossless_compress_matches_jax_cli(tmp_path, yuv_file, mode):
    src, vid = yuv_file
    pictures = "9" if mode == ["--whole_sequence"] else "13"
    tdata, jdata = _compress_both(
        tmp_path, ["--input", src, "--pictures", pictures, "--lossless",
                   "--GOPs", "2"] + ARGS + mode)
    assert tdata == jdata
    rec_p = str(tmp_path / "rec.yuv")
    assert cli.main(["expand", "--input", str(tmp_path / "t.qsvc"),
                     "--output", rec_p] + CPU) == 0
    rec = read_yuv(rec_p, 64, 48)
    np.testing.assert_array_equal(rec.y, vid.y[:int(pictures)])
    np.testing.assert_array_equal(rec.v, vid.v[:int(pictures)])


def test_resumed_compress_matches_jax_cli(tmp_path, yuv_file, capsys):
    """--resume writes the JAX CLI's file, and a second run serves every
    GOP from the store the JAX CLI wrote."""
    src, _ = yuv_file
    store = str(tmp_path / "ckpt")
    args = ["--input", src, "--pictures", "13", "--lossless",
            "--resume", store] + ARGS
    jout, tout = str(tmp_path / "j.qsvc"), str(tmp_path / "t.qsvc")
    assert jcli.main(["compress", "--output", jout] + args) == 0
    capsys.readouterr()
    assert cli.main(["compress", "--output", tout] + args + CPU) == 0
    assert capsys.readouterr().err.count("(cached)") == 3
    assert _read(tout) == _read(jout)


@pytest.fixture(scope="module")
def lossy_files(tmp_path_factory, yuv_file):
    """One lossy container, written by the JAX CLI (9/7 rounds in
    float32 differently in the two packages, so transcode is compared on
    one input)."""
    src, _ = yuv_file
    d = tmp_path_factory.mktemp("lossy")
    out = str(d / "in.qsvc")
    assert jcli.main(["compress", "--input", src, "--output", out,
                      "--pictures", "13", "--quantization_texture",
                      "43000"] + ARGS) == 0
    return d, out


@pytest.mark.parametrize("args", [
    ["--quantization", "45000"], ["--clayers", "2"],
    ["--discard_TRLs", "1"], ["--discard_SRLs", "1"],
    ["--BRC", "400", "--algorithm", "FS"],
    ["--BRC", "400", "--algorithm", "SR", "--discard_TRLs", "1"]],
    ids=["qs", "clayers", "ts", "ss", "brc_fs", "brc_sr_ts"])
def test_transcode_matches_jax_cli(lossy_files, args):
    d, src = lossy_files
    name = "_".join(a.strip("-") for a in args)
    tout, jout = str(d / f"t_{name}"), str(d / f"j_{name}")
    assert cli.main(["transcode", "--input", src, "--output", tout]
                    + args) == 0
    assert jcli.main(["transcode", "--input", src, "--output", jout]
                     + args) == 0
    assert _read(tout) == _read(jout)


def test_streaming_compress_expand(tmp_path, yuv_file):
    src, vid = yuv_file
    out = str(tmp_path / "a.qsvc")
    rec_p = str(tmp_path / "rec.yuv")
    # 13 frames, gop_size 4 -> 3 GOPs, streaming container
    assert cli.main(["compress", "--input", src, "--output", out,
                     "--pictures", "13", "--lossless"] + ARGS + CPU) == 0
    data = _read(out)
    assert codestream.is_gop_container(data)
    assert len(codestream.unpack_gop_streams(data)) == 3
    assert cli.main(["expand", "--input", out, "--output", rec_p]
                    + CPU) == 0
    rec = read_yuv(rec_p, 64, 48)
    assert rec.frames == 13
    np.testing.assert_array_equal(rec.y, vid.y)
    np.testing.assert_array_equal(rec.u, vid.u)


def test_arbitrary_frame_count_cli(tmp_path, yuv_file):
    src, vid = yuv_file
    out = str(tmp_path / "b.qsvc")
    rec_p = str(tmp_path / "rec.yuv")
    # 11 frames: not k*gop_size+1 -- tail GOP padded, decode crops
    assert cli.main(["compress", "--input", src, "--output", out,
                     "--pictures", "11", "--lossless"] + ARGS + CPU) == 0
    assert cli.main(["expand", "--input", out, "--output", rec_p]
                    + CPU) == 0
    rec = read_yuv(rec_p, 64, 48)
    assert rec.frames == 11
    np.testing.assert_array_equal(rec.y, vid.y[:11])


def test_resume_cli(tmp_path, yuv_file, capsys):
    src, vid = yuv_file
    out = str(tmp_path / "c.qsvc")
    args = ["compress", "--input", src, "--output", out, "--pictures",
            "13", "--lossless", "--resume", str(tmp_path / "ckpt")] + \
        ARGS + CPU
    assert cli.main(args) == 0
    capsys.readouterr()
    assert cli.main(args) == 0          # every GOP from the store
    assert capsys.readouterr().err.count("(cached)") == 3
    rec_p = str(tmp_path / "rec.yuv")
    assert cli.main(["expand", "--input", out, "--output", rec_p]
                    + CPU) == 0
    np.testing.assert_array_equal(read_yuv(rec_p, 64, 48).y, vid.y)


def test_info_transcode_rd_on_container(tmp_path, yuv_file, capsys):
    src, vid = yuv_file
    out = str(tmp_path / "d.qsvc")
    assert cli.main(["compress", "--input", src, "--output", out,
                     "--pictures", "13", "--quantization_texture",
                     "43000"] + ARGS + CPU) == 0
    capsys.readouterr()
    assert cli.main(["info", "--input", out]) == 0
    txt = capsys.readouterr().out
    assert "GOP 2" in txt and "total" in txt
    tout = str(tmp_path / "t.qsvc")
    assert cli.main(["transcode", "--input", out, "--output", tout,
                     "--quantization", "45000"]) == 0
    assert os.path.getsize(tout) < os.path.getsize(out)
    rec_p = str(tmp_path / "rec.yuv")
    assert cli.main(["expand", "--input", tout, "--output", rec_p]
                    + CPU) == 0
    assert read_yuv(rec_p, 64, 48).frames == 13
    capsys.readouterr()
    assert cli.main(["rd", "--input", out, "--original", src,
                     "--quantizations", "44000,45000"] + CPU) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l and not l.startswith("#")]
    assert len(lines) == 2


def test_search_slope_and_psnr_cli(tmp_path, yuv_file, capsys):
    src, _ = yuv_file
    out = str(tmp_path / "w.qsvc")
    assert cli.main(["compress", "--input", src, "--output", out,
                     "--pictures", "5", "--whole_sequence",
                     "--quantization_texture", "0"] + ARGS + CPU) == 0
    capsys.readouterr()
    assert cli.main(["search_slope", "--input", out, "--original", src,
                     "--distortion", "3.0"] + CPU) == 0
    assert capsys.readouterr().out.startswith("slope ")
    assert cli.main(["psnr", "--file_A", src, "--file_B", src,
                     "--pixels_in_x", "64", "--pixels_in_y", "48"]) == 0
    assert "inf dB" in capsys.readouterr().out


@pytest.mark.parametrize("command", ["compress", "expand", "rd",
                                     "search_slope"])
def test_device_cuda_without_card_raises(tmp_path, yuv_file, command):
    """--device defaults to cuda; a host without a card raises, it never
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, _ = yuv_file
    args = {"compress": ["--input", src, "--output",
                         str(tmp_path / "x.qsvc")] + ARGS,
            "expand": ["--input", "x", "--output", "y"],
            "rd": ["--input", "x", "--original", src],
            "search_slope": ["--input", "x", "--original", src,
                             "--distortion", "1"]}[command]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([command] + args)


def test_export_j2k_matches_jax_cli(tmp_path, yuv_file):
    src, _ = yuv_file
    args = ["--input", src, "--pixels_in_x", "64", "--pixels_in_y", "48",
            "--frame", "2", "--SRLs", "3", "--codeblock_size", "32",
            "--irreversible", "--layer_slopes", "46000,44000"]
    assert cli.main(["export_j2k", "--output", str(tmp_path / "t")]
                    + args) == 0
    assert jcli.main(["export_j2k", "--output", str(tmp_path / "j")]
                     + args) == 0
    for c in "YUV":
        assert _read(tmp_path / f"t_{c}.j2c") == \
            _read(tmp_path / f"j_{c}.j2c")


# ----------------------------------------------------------------- io

def _vix(path, vid):
    """A VIX file: magic, three two-line sections, dims, subsampling."""
    n, h, w = vid.y.shape
    with open(path, "wb") as f:
        f.write(b"vix\nvideo\nformat\ncolor\nyuv\nimage\n8 bit\n")
        f.write(f"{w} {h} 3\n1 1 2 2\n2 2\n".encode())
        for i in range(n):
            for p in vid.planes():
                f.write(p[i].tobytes())


def test_yuv_io_matches_jax(tmp_path):
    vid = synthetic_video(3, 48, 64, seed=2)
    tp, jp = str(tmp_path / "t.yuv"), str(tmp_path / "j.yuv")
    write_yuv(tp, vid)
    jyuv.write_yuv(jp, vid)
    assert _read(tp) == _read(jp)
    got, want = read_yuv(tp, 64, 48, 2), jyuv.read_yuv(tp, 64, 48, 2)
    for a, b in zip(got.planes(), want.planes()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.u, vid.u[:2])
    name = "/x/foreman_352x288x30x420x300.yuv"
    assert parse_geometry(name) == jyuv.parse_geometry(name) == \
        (352, 288, 30, 300)
    assert parse_geometry("plain.yuv") is None


def test_vix_io_matches_jax(tmp_path, capsys):
    vid = synthetic_video(2, 32, 48, seed=4)
    src = str(tmp_path / "in.vix")
    _vix(src, vid)
    got, want = read_vix(src), jyuv.read_vix(src)
    for a, b, c in zip(got.planes(), want.planes(), vid.planes()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    n = vix_to_raw(src, str(tmp_path / "raw.yuv"))
    assert n == jyuv.vix_to_raw(src, str(tmp_path / "jraw.yuv"))
    assert _read(tmp_path / "raw.yuv") == _read(tmp_path / "jraw.yuv")
    assert cli.main(["vix2raw", "--input", src, "--output",
                     str(tmp_path / "c.yuv")]) == 0
    assert f"{n} payload bytes" in capsys.readouterr().out
