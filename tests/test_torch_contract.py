"""PyTorch port: the functions that share a name with a JAX function keep
its contract.

Each function below is called exactly as the JAX function is called (its
arguments, shapes and defaults) on the same numpy inputs made from a
seed: the JAX package on the CPU against the port with CPU tensors.
Integer results must match exactly, ``histogram_entropy``'s float32
entropy within rtol 1e-6 (its p*log2(p) terms are summed in another
order than XLA's).  Each batched form the port's MCTF uses must equal
``jax.vmap`` of the JAX function (the sub-pixel prediction from a
level's evens: the JAX function on the evens' two slices).

Then ``api.prewarm`` / ``prewarm_decode`` must run the captured programs
of one real GOP under the keys that GOP's ``compress_chunks`` /
``expand_gops`` use, and the CLI must call them before a multi-GOP
compress and expand, as the JAX CLI does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qsvc_tpu.codec import frame_codec as jfc
from qsvc_tpu.mctf import predict as jpredict
from qsvc_tpu.mctf import update as jupdate
from qsvc_tpu.ops import blocks as jblocks
from qsvc_tpu.ops import entropy as jentropy
from qsvc_tpu_torch import api, cli
from qsvc_tpu_torch.codec import frame_codec
from qsvc_tpu_torch.codec.codestream import VideoStream
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video, write_yuv
from qsvc_tpu_torch.mctf import predict, update
from qsvc_tpu_torch.ops import blocks, entropy
from qsvc_tpu_torch.utils import graphs

torch.set_num_threads(1)

H, W, BS, P = 48, 64, 16, 2
BY, BX = H // BS, W // BS


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x]


def _assert_same(got, want, rtol=0.0):
    """Leaf by leaf: same shape and dtype; equal values (or within
    ``rtol``)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            g = g.numpy()
        w = np.asarray(w)
        g = np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype,
                                                           w.shape, w.dtype)
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol)
        else:
            np.testing.assert_array_equal(g, w)


def _frames(rng, n):
    """n frames of (y, u, v) int16 planes."""
    return (rng.integers(0, 256, (n, H, W)).astype(np.int16),
            rng.integers(0, 256, (n, H // 2, W // 2)).astype(np.int16),
            rng.integers(0, 256, (n, H // 2, W // 2)).astype(np.int16))


def _refs_mv(rng, n, reach=6):
    refs = rng.integers(0, 256, (2, n, 3, H, W)).astype(np.int16)
    mv = rng.integers(-reach, reach + 1, (n, 2, 2, BY, BX)).astype(np.int32)
    return refs[0], refs[1], mv


def _odd_pred(rng, n):
    """Odd frames, 4:4:4 predictions close to them (B frames) but for
    the last (an I frame candidate), and vectors."""
    oy, ou, ov = _frames(rng, n)
    pred = np.clip(np.repeat(oy[:, None], 3, 1)
                   + rng.integers(-6, 7, (n, 3, H, W)), 0, 255
                   ).astype(np.int16)
    pred[-1] = rng.integers(0, 256, (3, H, W))
    mv = rng.integers(-4, 5, (n, 2, 2, BY, BX)).astype(np.int32)
    return (oy, ou, ov), pred, mv


# ---- each function called the JAX way

def _histogram_entropy(rng):
    v = rng.integers(0, 256, (16, 16)).astype(np.int32)
    return (entropy.histogram_entropy(_t(v)),
            jentropy.histogram_entropy(_j(v)))


def _predict_frame(rng):
    rp, rn, mv = _refs_mv(rng, 1)
    return (predict.predict_frame(_t(rp[0]), _t(rn[0]), _t(mv[0]), BS, 16),
            jpredict.predict_frame(_j(rp[0]), _j(rn[0]), _j(mv[0]), BS, 16))


def _refs_to_444(rng):
    frame = tuple(p[0] for p in _frames(rng, 1))
    return (predict.refs_to_444(tuple(map(_t, frame))),
            jpredict.refs_to_444(tuple(map(_j, frame))))


def _predict_frames_subpixel(rng):
    rp, rn, mv = _refs_mv(rng, P, reach=9)
    return (predict.predict_frames_subpixel(_t(rp), _t(rn), _t(mv), BS, 4,
                                            1),
            jpredict.predict_frames_subpixel(_j(rp), _j(rn), _j(mv), BS, 4,
                                             1))


def _decorrelate_from_pred(rng):
    odd, pred, mv = _odd_pred(rng, 1)
    odd = tuple(p[0] for p in odd)
    return (predict.decorrelate_from_pred(tuple(map(_t, odd)), _t(pred[0]),
                                          _t(mv[0])),
            jpredict.decorrelate_from_pred(tuple(map(_j, odd)), _j(pred[0]),
                                           _j(mv[0])))


def _correlate_from_pred(rng):
    odd, pred, mv = _odd_pred(rng, 1)
    res = jpredict.decorrelate_from_pred(tuple(_j(p[0]) for p in odd),
                                         _j(pred[0]), _j(mv[0]))
    high = tuple(np.asarray(h) for h in res[:3])
    is_B = bool(res.is_B)
    return (predict.correlate_from_pred(tuple(map(_t, high)), _t(pred[0]),
                                        torch.tensor(is_B)),
            jpredict.correlate_from_pred(tuple(map(_j, high)), _j(pred[0]),
                                         jnp.bool_(is_B)))


def _residue_to_444(rng):
    high = tuple(p[0] for p in _frames(rng, 1))
    return (update.residue_to_444(tuple(map(_t, high)), torch.tensor(True)),
            jupdate.residue_to_444(tuple(map(_j, high)), jnp.bool_(True)))


def _gather_block_patches(rng):
    img = rng.integers(0, 256, (3, H + 32, W + 32)).astype(np.int16)
    sy = rng.integers(0, H + 32 - 24, (BY, BX)).astype(np.int32)
    sx = rng.integers(0, W + 32 - 20, (BY, BX)).astype(np.int32)
    return (blocks.gather_block_patches(_t(img), _t(sy), _t(sx), 24, 20),
            jblocks.gather_block_patches(_j(img), _j(sy), _j(sx), 24, 20))


def _blocks_to_image(rng):
    b = rng.integers(0, 256, (BY, BX, 3, BS, BS)).astype(np.int16)
    return blocks.blocks_to_image(_t(b)), jblocks.blocks_to_image(_j(b))


def _texture_stack(rng):
    """Reversible (integer) planes with flat and textured regions, so the
    selection keeps some code-blocks and drops others."""
    planes = np.full((3, 128, 128), 128, np.uint8)
    planes[:, 64:, 64:] = rng.integers(0, 256, (3, 64, 64))
    return planes


def _encode_frames_select_sparse(rng):
    planes, thr = _texture_stack(rng), np.zeros(3)
    pend = frame_codec.encode_frames_dispatch_sparse(_t(planes), 3, True,
                                                     0.125, 32, thr)
    jpend = jfc.encode_frames_dispatch_sparse(_j(planes), 3, True, 0.125,
                                              32, thr)
    got = frame_codec.encode_frames_select_sparse(pend, thr)
    want = jfc.encode_frames_select_sparse(jpend, thr)
    k, (n, nb, _) = len(want[2]), want[3]
    assert got[0] == want[0] == "sparse" and 0 < k < n * nb
    # the JAX prefix is bucketed to a power of two; the kept ones lead
    assert got[1].shape[0] == k
    return ((got[1], got[2], got[3], got[4:]),
            (want[1][:k], want[2], want[3], want[4:]))


def _decode_frames(rng):
    efs = jfc.encode_frames(_texture_stack(rng), 3, True, 0.125, 32, 0.0,
                            "bp")
    got = frame_codec.decode_frames(efs, device="cpu")
    assert isinstance(got, np.ndarray)
    return got, jfc.decode_frames(efs)


CONTRACT = {
    "histogram_entropy": _histogram_entropy,
    "predict_frame": _predict_frame,
    "refs_to_444": _refs_to_444,
    "predict_frames_subpixel": _predict_frames_subpixel,
    "decorrelate_from_pred": _decorrelate_from_pred,
    "correlate_from_pred": _correlate_from_pred,
    "residue_to_444": _residue_to_444,
    "gather_block_patches": _gather_block_patches,
    "blocks_to_image": _blocks_to_image,
    "encode_frames_select_sparse": _encode_frames_select_sparse,
    "decode_frames": _decode_frames,
}


@pytest.mark.parametrize("name", sorted(CONTRACT))
def test_called_the_jax_way_gives_the_jax_result(name):
    rng = np.random.default_rng(sorted(CONTRACT).index(name))
    got, want = CONTRACT[name](rng)
    _assert_same(got, want, rtol=1e-6 if name == "histogram_entropy" else 0)


# ---- the batched forms against jax.vmap of the JAX function

def _histogram_entropy_rows(rng):
    v = rng.integers(0, 256, (3, 16, 16)).astype(np.int32)
    return (entropy.histogram_entropy_rows(_t(v)),
            jax.vmap(jentropy.histogram_entropy)(_j(v)))


def _predict_frames_plain(rng):
    rp, rn, mv = _refs_mv(rng, P)
    return (predict.predict_frames_plain(_t(rp), _t(rn), _t(mv), BS, 16),
            jax.vmap(lambda a, b, m: jpredict.predict_frame(
                a, b, m, BS, 16))(_j(rp), _j(rn), _j(mv)))


def _refs_to_444_batch(rng):
    frames = _frames(rng, P)
    return (predict.refs_to_444_batch(tuple(map(_t, frames))),
            jax.vmap(jpredict.refs_to_444)(tuple(map(_j, frames))))


def _predict_frames_subpixel_evens(rng):
    evens = rng.integers(0, 256, (P + 1, 3, H, W)).astype(np.int16)
    mv = rng.integers(-9, 10, (P, 2, 2, BY, BX)).astype(np.int32)
    return (predict.predict_frames_subpixel_evens(_t(evens), _t(mv), BS, 4,
                                                  1),
            jpredict.predict_frames_subpixel(_j(evens[:-1]), _j(evens[1:]),
                                             _j(mv), BS, 4, 1))


def _decorrelate_from_preds(rng):
    odd, pred, mv = _odd_pred(rng, P)
    return (predict.decorrelate_from_preds(tuple(map(_t, odd)), _t(pred),
                                           _t(mv)),
            jax.vmap(jpredict.decorrelate_from_pred)(
                tuple(map(_j, odd)), _j(pred), _j(mv)))


def _correlate_from_preds(rng):
    odd, pred, mv = _odd_pred(rng, P)
    res = jax.vmap(jpredict.decorrelate_from_pred)(
        tuple(map(_j, odd)), _j(pred), _j(mv))
    high = tuple(np.asarray(h) for h in res[:3])
    is_B = np.asarray(res.is_B)
    return (predict.correlate_from_preds(tuple(map(_t, high)), _t(pred),
                                         _t(is_B)),
            jax.vmap(jpredict.correlate_from_pred)(
                tuple(map(_j, high)), _j(pred), _j(is_B)))


def _residues_to_444(rng):
    high = _frames(rng, P)
    is_B = np.array([True, False])
    return (update.residues_to_444(tuple(map(_t, high)), _t(is_B)),
            jax.vmap(jupdate.residue_to_444)(tuple(map(_j, high)),
                                             _j(is_B)))


def _gather_block_rows(rng):
    img = rng.integers(0, 256, (P, 3, H + 32, W + 32)).astype(np.int16)
    sy = rng.integers(0, H + 32 - 24, (P, BY, BX)).astype(np.int32)
    sx = rng.integers(0, W + 32 - 20, (P, BY, BX)).astype(np.int32)
    rows = sy[..., None] + np.arange(24)
    cols = sx[..., None] + np.arange(20)
    return (blocks.gather_block_rows(_t(img), _t(rows), _t(cols)),
            jax.vmap(lambda im, y, x: jblocks.gather_block_patches(
                im, y, x, 24, 20))(_j(img), _j(sy), _j(sx)))


def _blocks_to_images(rng):
    b = rng.integers(0, 256, (P, BY, BX, 3, BS, BS)).astype(np.int16)
    return (blocks.blocks_to_images(_t(b)),
            jax.vmap(jblocks.blocks_to_image)(_j(b)))


BATCHED = {
    "histogram_entropy_rows": _histogram_entropy_rows,
    "predict_frames_plain": _predict_frames_plain,
    "refs_to_444_batch": _refs_to_444_batch,
    "predict_frames_subpixel_evens": _predict_frames_subpixel_evens,
    "decorrelate_from_preds": _decorrelate_from_preds,
    "correlate_from_preds": _correlate_from_preds,
    "residues_to_444": _residues_to_444,
    "gather_block_rows": _gather_block_rows,
    "blocks_to_images": _blocks_to_images,
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_form_is_the_vmap_of_the_jax_function(name):
    rng = np.random.default_rng(100 + sorted(BATCHED).index(name))
    got, want = BATCHED[name](rng)
    _assert_same(got, want,
                 rtol=1e-6 if name == "histogram_entropy_rows" else 0)


# ---- prewarm: the programs of one real GOP, ahead of it

GOP_KW = dict(pixels_in_x=64, pixels_in_y=48, TRLs=3, SRLs=3, block_size=16,
              search_range=4, GOPs=2)
#: (reversible, cfg overrides): lossy 9/7 (the sparse decode) and
#: lossless 5/3 (the dense decode)
OPERATING_POINTS = {"lossy": (False, {}),
                    "lossless": (True, dict(quantization_texture=0))}


@pytest.fixture
def keys(monkeypatch):
    """The graph keys of the captured programs' calls, in order (on the
    CPU each call still goes through ``graphs._run``, which runs it
    eagerly)."""
    seen = []
    run = graphs._run

    def record(fn, leaves, spec):
        seen.append(graphs._key(fn, spec, leaves))
        return run(fn, leaves, spec)
    monkeypatch.setattr(graphs, "_run", record)
    return seen


def _taken(keys):
    out = set(keys)
    keys.clear()
    return out


@pytest.mark.parametrize("point", sorted(OPERATING_POINTS))
def test_prewarm_runs_the_programs_of_a_real_gop(keys, point):
    reversible, kw = OPERATING_POINTS[point]
    cfg = CodecConfig(**GOP_KW, **kw)
    vid = synthetic_video(cfg.pictures, 48, 64, seed=5)
    seconds = api.prewarm(cfg, reversible=reversible, device="cpu")
    assert seconds > 0
    warmed = _taken(keys)
    S = cfg.gop_size
    streams = api.compress_chunks([vid[:S + 1], vid[S:]],
                                  cfg.replace(GOPs=1), reversible,
                                  device="cpu")
    assert _taken(keys) == warmed and len(warmed) == 4

    parsed = [VideoStream.from_bytes(s.to_bytes()) for s in streams]
    seconds = api.prewarm_decode(parsed[0].cfg, reversible=reversible,
                                 delta=parsed[0].delta or None,
                                 device="cpu")
    assert seconds > 0
    warmed = _taken(keys)
    api.expand_gops(parsed, device="cpu")
    assert _taken(keys) == warmed and len(warmed) == 6


def test_cli_prewarms_a_multi_gop_compress_and_expand(tmp_path, keys,
                                                      monkeypatch):
    """Every program the CLI runs after its prewarm was run by it."""
    src, out = str(tmp_path / "in.yuv"), str(tmp_path / "out.qsvc")
    write_yuv(src, synthetic_video(13, 48, 64, seed=6))
    calls = []
    for name in ("prewarm", "prewarm_decode"):
        def wrapped(*a, _fn=getattr(api, name), _name=name, **k):
            calls.append(_name)
            seconds = _fn(*a, **k)
            calls.append(_taken(keys))
            return seconds
        monkeypatch.setattr(api, name, wrapped)
    geometry = ["--pixels_in_x", "64", "--pixels_in_y", "48", "--TRLs", "3",
                "--SRLs", "3", "--block_size", "16", "--search_range", "2"]
    assert cli.main(["compress", "--input", src, "--output", out,
                     "--pictures", "13"] + geometry
                    + ["--device", "cpu"]) == 0
    assert calls[0] == "prewarm" and _taken(keys) <= calls[1]
    assert cli.main(["expand", "--input", out, "--output",
                     str(tmp_path / "rec.yuv"), "--device", "cpu"]) == 0
    assert calls[2] == "prewarm_decode" and _taken(keys) <= calls[3]
