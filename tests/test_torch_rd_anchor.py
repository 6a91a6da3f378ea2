"""PyTorch port: the external RD anchor (CPU).

``tests/test_rd_anchor.py``'s two claims, run on the port with the same
fixture and bounds: MCTF beats OpenJPEG coding the same frames intra at
a matched rate on temporally redundant content, and sub-pixel ME tracks
fractional motion.  The full artifact is written by
``python3 -m qsvc_tpu_torch.tools.rd_harness`` (``RD_torch.json``)."""

import pytest
import torch

from qsvc_tpu_torch import api
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.scal import anchor, rd as rdmod

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not anchor.available(),
                                reason="Pillow built without OpenJPEG")


@pytest.fixture(scope="module")
def translating():
    cfg = CodecConfig(pixels_in_x=176, pixels_in_y=144, TRLs=3, GOPs=1,
                      block_size=16, search_range=4, SRLs=4,
                      quantization_texture=42000, nLayers=9,
                      update_factor=0.25)
    vid = synthetic_video(cfg.pictures, 144, 176, seed=5, kind="translate",
                          velocity=(1.0, 2.0))
    return cfg, vid


@pytest.mark.parametrize("coder,min_adv_db", [("mq", 2.0), ("bp", 0.5)])
def test_mctf_beats_intra_at_matched_rate(translating, coder, min_adv_db):
    cfg, vid = translating
    vs = api.compress(vid, cfg.replace(texture_coder=coder),
                      reversible=False, device="cpu")
    (pt,) = rdmod.rd_curve(vs, vid, [44500.0], device="cpu")
    n_opj, dec_opj, _ = anchor.match_rate(vid, pt.bytes)
    opj_psnr = anchor.psnr_y(vid, dec_opj)
    # matched-rate guard: the anchor may not be given a bigger budget
    assert n_opj <= pt.bytes * 1.05, (n_opj, pt.bytes)
    assert pt.psnr_y >= opj_psnr + min_adv_db, (
        f"MCTF {pt.psnr_y:.2f} dB at {pt.bytes} B vs OpenJPEG-intra "
        f"{opj_psnr:.2f} dB at {n_opj} B")


def test_subpixel_me_tracks_fractional_motion(translating):
    """Fractional global motion: sub-pixel ME must still beat intra at a
    mid rate."""
    cfg, _ = translating
    vid = synthetic_video(cfg.pictures, 144, 176, seed=7, kind="translate",
                          velocity=(1.5, 2.5))
    vs = api.compress(vid, cfg.replace(subpixel_accuracy=1,
                                       texture_coder="mq"),
                      reversible=False, device="cpu")
    (pt,) = rdmod.rd_curve(vs, vid, [44500.0], device="cpu")
    n_opj, dec_opj, _ = anchor.match_rate(vid, pt.bytes)
    assert n_opj <= pt.bytes * 1.05
    assert pt.psnr_y >= anchor.psnr_y(vid, dec_opj) + 1.0
