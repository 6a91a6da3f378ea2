"""The port's streamed encode at quarter-pel motion (``subpixel_accuracy``
2) against the benchmark's plain reference (``benchmark/reference``),
which decides ``correct`` in the ``hd1080-subpel2.encode`` cell: on the
CPU at 64x128 (TRLs 3), every GOP stream byte-identical, the vectors
really quarter-pel, the header carrying the accuracy."""

import pytest
import torch

from benchmark.content import translate
from benchmark.reference import encode as reference
from benchmark.reference.config import CodecConfig as RefConfig
from qsvc_tpu_torch import api
from qsvc_tpu_torch.codec.codestream import VideoStream
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io.yuv import Video
from qsvc_tpu_torch.mctf import transform

GEOMETRY = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, SRLs=3,
                block_size=16, search_range=4)
#: the cell's mix: (1.25, 2.5) pixels a frame
MIX = {"content_seed": 11, "velocity_y": 1.25, "velocity_x": 2.5}


@pytest.mark.parametrize("a", [1, 2])
def test_compress_chunks_subpel_equals_the_reference(a):
    cfg = CodecConfig(**GEOMETRY, GOPs=2, subpixel_accuracy=a)
    S = cfg.gop_size
    y, u, v = translate.make(cfg.pictures, 64, 128, MIX, "cpu")
    chunks = [Video(y, u, v)[g * S:(g + 1) * S + 1] for g in range(2)]
    gop_cfg = cfg.replace(GOPs=1)
    streams = [vs.to_bytes() for vs in api.compress_chunks(
        chunks, gop_cfg, reversible=False, window=2, device="cpu")]
    rcfg = RefConfig(**GEOMETRY, GOPs=1, subpixel_accuracy=a)
    for chunk, data in zip(chunks, streams):
        assert reference.encode(chunk.y, chunk.u, chunk.v, rcfg,
                                "cpu") == data
        assert VideoStream.from_bytes(data).cfg.subpixel_accuracy == a
    # the vectors come in units of 2^-a pixel and are not all whole
    mctf = transform.analyze(*(torch.from_numpy(p)
                               for p in (chunks[0].y, chunks[0].u,
                                         chunks[0].v)), gop_cfg)
    mv = mctf.levels[0].mv
    assert (mv % (1 << a) != 0).any()
