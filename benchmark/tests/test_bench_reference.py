"""The plain reference agrees with the program at small sizes on the CPU:
the whole stream, the bp block coder and the motion fields' MQ coder;
and its control, computed in bfloat16, does not."""

import numpy as np
import pytest
import torch

from benchmark import check, control, spec as specs
from benchmark.reference import encode as reference
from benchmark.reference.codec import bp, reader, tier1
from benchmark.reference.config import CodecConfig as RefConfig

GEOMETRIES = [(64, 128, 3, 3, 16), (128, 192, 4, 4, 32)]


@pytest.mark.parametrize("H,W,trls,srls,bs", GEOMETRIES)
def test_reference_stream_equals_the_programs(H, W, trls, srls, bs):
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io.yuv import synthetic_video
    kw = dict(pixels_in_x=W, pixels_in_y=H, TRLs=trls, SRLs=srls,
              block_size=bs, search_range=4, GOPs=1)
    vid = synthetic_video(CodecConfig(**kw).pictures, H, W, seed=3)
    prog = api.compress_chunks([vid], CodecConfig(**kw), reversible=False,
                               device="cpu")[0].to_bytes()
    assert reference.encode(vid.y, vid.u, vid.v, RefConfig(**kw),
                            "cpu") == prog


def test_reference_sharded_sequence_equals_the_programs():
    from qsvc_tpu_torch import api
    from qsvc_tpu_torch.config import CodecConfig
    from qsvc_tpu_torch.io.yuv import synthetic_video
    kw = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, SRLs=3,
              block_size=16, search_range=4, GOPs=4)
    vid = synthetic_video(CodecConfig(**kw).pictures, 64, 128, seed=5)
    prog = api.compress(vid, CodecConfig(**kw), reversible=False,
                        device="cpu").to_bytes()
    assert reference.encode(vid.y, vid.u, vid.v, RefConfig(**kw),
                            "cpu") == prog


def _random_blocks(seed, n):
    rng = np.random.default_rng(seed)
    tiles, th, tw, ms = [], [], [], []
    for _ in range(n):
        h = int(rng.choice([64, 64, 4, 17, 33]))
        w = int(rng.choice([64, 60, 8, 1, 30]))
        scale = float(rng.choice([1, 3, 20, 300, 3000]))
        t = np.zeros((64, 64), np.int64)
        t[:h, :w] = np.round(rng.laplace(0, scale, (h, w))
                             * (rng.random((h, w)) < rng.random()))
        tiles.append(t)
        th.append(h)
        tw.append(w)
        ms.append(float(rng.choice([0.0, 0.5, 5.0, 50.0, 1e9])))
    return tiles, th, tw, ms


@pytest.mark.parametrize("seed", [0, 1])
def test_bp_coder_equals_the_native_coder(seed):
    from qsvc_tpu_torch.codec import fast
    tiles, th, tw, ms = _random_blocks(seed, 120)
    got = bp.encode_blocks(torch.from_numpy(np.stack(tiles)).to(torch.int32),
                           th, tw, ms)
    for i, g in enumerate(got):
        w = fast._bp_encode_tiles([tiles[i][:th[i], :tw[i]]], [ms[i]])[0]
        assert (g.data, g.msbs, g.pass_ends, g.pass_dist, g.dist0) == \
            (w.data, w.msbs, w.pass_ends, w.pass_dist, w.dist0)


def test_motion_coder_equals_the_native_coder():
    from qsvc_tpu_torch.codec import fast
    rng = np.random.default_rng(7)
    tiles = [rng.integers(-40, 41, (17, 30)).astype(np.int64)
             * (rng.random((17, 30)) < 0.3) for _ in range(6)]
    native = fast.encode_codeblocks_batch(tiles, ["LL"] * len(tiles))
    for t, n in zip(tiles, native):
        s = tier1.encode_codeblock(t, "LL")
        assert (s.data, s.msbs, list(s.pass_ends)) == \
            (n.data, n.msbs, list(n.pass_ends))


def _over(row):
    return [k for k, lim in check.LIMITS.items()
            if row[k] is None or row[k] > lim]


@pytest.mark.parametrize("seed", [2200000001, 2200000002, 2200000003])
def test_control_fails_the_check(tiny_root, seed):
    cell = specs.load_cell("hd1080-lossy.encode", tiny_root)
    row = control.readings(cell, seed, torch.device("cpu"))
    assert _over(row) and row["answers_missing"] == 0
    assert row["layout_differing"] == 0     # the motion is integer


def test_control_fails_the_sharded_check(tiny_root):
    cell = specs.load_cell("hd1080-lossy-4card.encode", tiny_root)
    row = control.readings(cell, 1, torch.device("cpu"))
    assert _over(row) and row["failed"] == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_bp_decoder_inverts_the_coder(seed):
    """Every pass decoded gives the coefficients back; the first n passes
    leave exactly the coder's squared error after pass n."""
    tiles, th, tw, ms = _random_blocks(seed, 120)
    t = torch.from_numpy(np.stack(tiles))
    codes = bp.encode_blocks(t.to(torch.int32), th, tw, ms)
    rng = np.random.default_rng(seed)
    whole, cut, want = [], [], []
    for i, c in enumerate(codes):
        lens = np.diff([0] + c.pass_ends).tolist()
        whole.append((c.msbs, lens, c.data, (th[i], tw[i])))
        n = int(rng.integers(0, len(lens) + 1))
        cut.append((c.msbs, lens[:n], c.data[:sum(lens[:n])],
                    (th[i], tw[i])))
        want.append(c.pass_dist[n - 1] if n else c.dist0)
    rec = bp.decode_blocks(whole, 64, "cpu")
    full = [c.pass_dist[-1] if c.pass_dist else c.dist0 for c in codes]
    assert ((t - rec) ** 2).sum(dim=(1, 2)).tolist() == full
    rec = bp.decode_blocks(cut, 64, "cpu")
    assert ((t - rec) ** 2).sum(dim=(1, 2)).tolist() == want


def test_stream_reader_splits_layout_from_texture():
    kw = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, SRLs=3,
              block_size=16, search_range=4, GOPs=1)
    from benchmark.content import moving
    cfg = RefConfig(**kw)
    y, u, v = moving.make(cfg.pictures, 64, 128, {"content_seed": 9}, "cpu")
    data, truth = reference.encode(y, u, v, cfg, "cpu", truth=True)
    parsed = reader.parse(data)
    assert len(parsed.frames) == len(truth.tiles) == 3 * cfg.pictures
    assert len(truth.thresholds) == len(truth.tiles)
    assert check.rd_cost(parsed.frames, truth, "cpu") > 0
    # the control's stream keeps the layout and codes the texture worse
    low = reader.parse(reference.encode(y, u, v, cfg, "cpu",
                                        torch.bfloat16))
    assert low.layout == parsed.layout
    # a stream that is cut short does not parse
    with pytest.raises(ValueError):
        reader.parse(data[:-1])
