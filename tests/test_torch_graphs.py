"""PyTorch port: the captured programs (``qsvc_tpu_torch/utils/graphs.py``)
against the JAX package's jitted ones, on the CPU.

On CPU tensors a captured program runs its eager function, so these
tests hold the port's ``analyze_jit``, ``synthesize_jit`` (with
``discard_TRLs``), ``decorrelate_jit``, ``correlate_jit`` and the
texture stages to the JAX package's ``jax.jit`` programs, plus the
static key and the ops the programs may use inside a CUDA graph
capture.  ``tests/test_torch_cuda.py`` holds replay == eager on the
card."""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from qsvc_tpu import api as japi
from qsvc_tpu.codec import bp_device as jbp
from qsvc_tpu.codec import frame_codec as jfc
from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.mctf import motion_coding as jmotion
from qsvc_tpu.mctf import transform as jtransform
from qsvc_tpu_torch.codec import frame_codec
from qsvc_tpu_torch.codec.frame_codec import slope_to_threshold
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.mctf import motion_coding, transform
from qsvc_tpu_torch.utils import graphs

torch.set_num_threads(1)

_SMALL = dict(pixels_in_x=64, pixels_in_y=48, TRLs=3, GOPs=1, block_size=16,
              search_range=2, update_factor=0.25)
CASES = {"whole-pixel": _SMALL,
         "a=1": dict(_SMALL, subpixel_accuracy=1),
         "ola_d4": dict(_SMALL, block_overlaping=4),
         "border2": dict(_SMALL, border_size=2)}


def _flat(stream):
    out = [stream.low_y, stream.low_u, stream.low_v]
    for lev in stream.levels:
        out += list(lev)
    return [np.asarray(a) for a in out]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = CASES[request.param]
    cfg = JaxConfig(**kw)
    vid = synthetic_video(cfg.pictures, kw["pixels_in_y"],
                          kw["pixels_in_x"], seed=5, kind="translate")
    jstream = jtransform.analyze_jit(*(jnp.asarray(p) for p in vid.planes()),
                                     cfg)
    return kw, vid, jstream


def test_analyze_jit_matches_jax(case):
    kw, vid, jstream = case
    got = transform.analyze_jit(*(torch.from_numpy(p) for p in vid.planes()),
                                CodecConfig(**kw))
    assert isinstance(got, transform.MCTFStream)
    for g, w in zip(_flat(got.to_numpy()), _flat(jstream), strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("discard", [0, 1])
def test_synthesize_jit_matches_jax(case, discard):
    """discard 0 against ``synthesize_jit``; discard 1 against the JAX
    package's ``api._synthesize_partial`` (the coarser levels only)."""
    kw, _, jstream = case
    cfg = CodecConfig(**kw)
    stream = transform.MCTFStream.from_numpy(jstream, device="cpu")
    if discard:
        jstream = jtransform.MCTFStream(jstream.low_y, jstream.low_u,
                                        jstream.low_v, jstream.levels[1:])
        stream = stream._replace(levels=stream.levels[1:])
        want = japi._synthesize_partial(jstream, JaxConfig(**kw), 1)
    else:
        want = jtransform.synthesize_jit(jstream, JaxConfig(**kw))
    got = transform.synthesize_jit(stream, cfg, discard_TRLs=discard)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_motion_coding_jit_matches_jax(rng):
    fields = [rng.integers(-9, 10, (4, 2, 2, 5, 6)).astype(np.int32),
              rng.integers(-9, 10, (2, 2, 2, 3, 3)).astype(np.int32),
              rng.integers(-9, 10, (1, 2, 2, 3, 3)).astype(np.int32)]
    want = jmotion.decorrelate_jit([jnp.asarray(f) for f in fields])
    got = motion_coding.decorrelate_jit([torch.from_numpy(f)
                                         for f in fields])
    assert isinstance(got, list)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = motion_coding.correlate_jit(got)
    jback = jmotion.correlate_jit(want)
    for b, jb, f in zip(back, jback, fields, strict=True):
        np.testing.assert_array_equal(b.numpy(), f)
        np.testing.assert_array_equal(np.asarray(jb), f)


def _stage1_inputs(q, reversible):
    rng = np.random.default_rng(q)
    sigma = np.repeat([0.4, 3.0, 30.0], [30, 30, 28])
    planes = np.clip(128 + rng.normal(0, 1, (3, 72, 88)) * sigma, 0, 255
                     ).astype(np.int16)
    return planes, np.full(3, slope_to_threshold(q)), (0.125 if reversible
                                                       else 1.5)


@pytest.mark.parametrize("reversible,q", [(True, 46000), (False, 44000),
                                          (False, 45000)])
def test_encode_stage1_matches_jax_stages(reversible, q):
    """The captured stage 1 (``_encode_device_jit``) against the JAX
    package's three jitted stages run in a row: 5/3 exact throughout;
    9/7 (float32 DWT and R-D sums) the same keep mask and compacted tiles,
    as ``test_torch_codec.test_dispatch_keep_masks_match_jax`` holds the
    eager stage."""
    planes, thr, delta = _stage1_inputs(q, reversible)
    levels, cb = 3, 16
    jt, jmax, _, jovf = jfc._dwt_quant_tiles(
        jnp.asarray(planes), levels, reversible, jnp.float32(delta), cb)
    N, nb = jt.shape[0], jt.shape[1]
    th, tw = frame_codec._tile_dims(72, 88, levels, cb)
    jsmax, _ = jbp.bp_max_slope(jt.reshape(N * nb, cb, cb),
                                jnp.asarray(np.tile(th, N)),
                                jnp.asarray(np.tile(tw, N)))
    tpl = frame_codec._tile_template(72, 88, levels, cb)
    ms = frame_codec._slope_floor(thr, N, nb, tpl, reversible, delta, "bp")
    jcompact, jkeep = jfc._compact_tiles(jt, jmax, jsmax.reshape(N, nb),
                                         jnp.asarray(ms))
    compact, maxabs, keep, ovf = frame_codec._encode_device_jit(
        torch.from_numpy(planes), torch.tensor(delta, dtype=torch.float32),
        *frame_codec._tile_dims_on(72, 88, levels, cb, N, "cpu"),
        torch.from_numpy(ms), levels, reversible, cb)
    keep_t = keep.numpy()
    assert keep_t.any() and (~keep_t & (maxabs.numpy() > 0)).any()
    np.testing.assert_array_equal(keep_t, np.asarray(jkeep))
    np.testing.assert_array_equal(maxabs.numpy(), np.asarray(jmax))
    assert bool(ovf) == bool(jovf) is False
    k = int(keep_t.sum())
    np.testing.assert_array_equal(compact[:k].numpy(),
                                  np.asarray(jcompact)[:k])
    if reversible:
        np.testing.assert_array_equal(compact.numpy(), np.asarray(jcompact))


@pytest.mark.parametrize("reversible", [True, False])
def test_dequant_idwt_jit_matches_jax(reversible):
    """5/3 exact; 9/7 rounds its float32 synthesis, so a pixel may land
    on the other side of .5 (``test_torch_codec``'s bound)."""
    rng = np.random.default_rng(7)
    q = rng.integers(-40, 41, (2, 48, 64)).astype(np.int32)
    q[:, :6, :8] += 100                              # an LL corner
    delta = np.float32(0.125 if reversible else 1.25)
    want = np.asarray(jfc._dequant_idwt(jnp.asarray(q), 3, reversible,
                                        jnp.asarray(delta)))
    got = frame_codec._dequant_idwt_jit(torch.from_numpy(q), 3, reversible,
                                        torch.tensor(delta)).numpy()
    if reversible:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() <= 1e-3


# ---- the captured programs' static key and CPU path

def test_key_separates_shapes_and_static_arguments():
    cfg = CodecConfig(**_SMALL)
    y = torch.zeros((9, 48, 64), dtype=torch.uint8)
    u = torch.zeros((9, 24, 32), dtype=torch.uint8)

    def key(*a, **kw):
        return graphs.graph_key(transform.analyze, *a, **kw)
    same = key(y.clone(), u.clone(), u.clone(), CodecConfig(**_SMALL))
    assert key(y, u, u, cfg) == same and hash(key(y, u, u, cfg)) == hash(same)
    assert key(y, u, u, cfg) != key(y[:5], u[:5], u[:5], cfg)
    assert key(y, u, u, cfg) != key(y.to(torch.int16), u, u, cfg)
    assert key(y, u, u, cfg) != key(y, u, u, cfg.replace(border_size=2))
    assert (graphs.graph_key(transform.synthesize, y, cfg, discard_TRLs=1)
            != graphs.graph_key(transform.synthesize, y, cfg))
    assert graphs.graph_key(transform.analyze, y) != \
        graphs.graph_key(transform.synthesize, y)


def test_key_reads_through_containers():
    """Lists and NamedTuples are part of the key: their lengths, types
    and every tensor in them."""
    a = torch.zeros((4, 2, 2, 3, 4), dtype=torch.int32)
    b = torch.zeros((2, 2, 2, 2, 2), dtype=torch.int32)
    fn = motion_coding.decorrelate
    assert graphs.graph_key(fn, [a, b]) == graphs.graph_key(fn, [a + 1, b])
    assert graphs.graph_key(fn, [a, b]) != graphs.graph_key(fn, [a, a])
    assert graphs.graph_key(fn, [a, b]) != graphs.graph_key(fn, [a, b, b])
    assert graphs.graph_key(fn, [a, b]) != graphs.graph_key(fn, (a, b))
    lev = transform.LevelData(a, a, a, a, a)
    st = transform.MCTFStream(a, a, a, (lev,))
    assert graphs.graph_key(fn, st) != graphs.graph_key(fn, tuple(st))


def test_flatten_round_trips_nested_named_tuples():
    a, b = torch.ones(2), torch.zeros(3)
    st = transform.MCTFStream(a, b, a, (transform.LevelData(a, b, a, b, a),
                                        transform.LevelData(b, a, b, a, b)))
    tree = ((st, [a, 3, "x"]), (("discard_TRLs", 1),))
    leaves = []
    spec = graphs._flatten(tree, leaves)
    assert len(leaves) == 3 + 2 * 5 + 3 + 2
    back = graphs._unflatten(spec, iter(leaves))
    again = []
    assert graphs._flatten(back, again) == spec
    assert all(x is y for x, y in zip(again, leaves, strict=True))
    assert type(back[0][0]) is transform.MCTFStream
    assert type(back[0][0].levels[1]) is transform.LevelData
    assert type(back[0][1]) is list


def test_cpu_calls_run_the_eager_function():
    """On CPU tensors the wrapper returns the eager function's own result
    and keeps no graph."""
    seen = []

    def fn(x, k):
        seen.append(x)
        return x * k
    wrapped = graphs.captured(fn)
    x = torch.arange(6)
    out = wrapped(x, 3)
    assert seen == [x] and seen[0] is x
    assert torch.equal(out, x * 3)
    assert wrapped.__name__ == "fn" and not graphs.stats()
    assert wrapped(5, 2) == 10                     # no tensor at all


# ---- what a CUDA graph capture forbids

#: ops that read a device value back to the host on CUDA (or whose CUDA
#: kernel does so to size its output): forbidden inside a capture
HOST_SYNC_OPS = {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
                 "aten.nonzero", "aten.bincount", "aten.masked_select",
                 "aten.unique", "aten._unique", "aten._unique2",
                 "aten.unique_consecutive", "aten.unique_dim",
                 "aten.repeat_interleave", "aten.histc", "aten.equal",
                 "aten.allclose"}


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(CASES))
def test_programs_use_no_host_sync(name):
    """Every captured program's code path (as far as the CPU runs it: the
    kernels' plain versions stand in for K1-K3) uses no op that waits for
    the device on CUDA, which no capture allows."""
    kw = CASES[name]
    cfg = CodecConfig(**kw)
    vid = synthetic_video(cfg.pictures, kw["pixels_in_y"], kw["pixels_in_x"],
                          seed=5, kind="translate")
    planes = [torch.from_numpy(p) for p in vid.planes()]
    with _OpLog() as log:
        st = transform.analyze(*planes, cfg)
        transform.synthesize(st, cfg)
        transform.synthesize(st._replace(levels=st.levels[1:]), cfg, 1)
        res = motion_coding.decorrelate([lev.mv for lev in st.levels])
        motion_coding.correlate(res)
        for rev in (True, False):
            luma = torch.cat([st.low_y] + [lev.high_y for lev in st.levels])
            d = torch.tensor(1.0)
            N, H, W = luma.shape
            nb = len(frame_codec._tile_template(H, W, 2, 16))
            q = frame_codec._encode_device(
                luma, d, *frame_codec._tile_dims_on(H, W, 2, 16, N, "cpu"),
                torch.zeros((N, nb)), 2, rev, 16)
            frame_codec._dequant_idwt(frame_codec._dwt_quant(luma, 2, rev,
                                                             d), 2, rev, d)
    assert q[2].any()
    assert not set(log.ops) & HOST_SYNC_OPS, set(log.ops) & HOST_SYNC_OPS


def test_capture_counts_launches_into_its_record():
    """While a graph is captured, a wrapper's launch goes to the graph's
    record (each replay adds it), not to ``cuda_lib.launches``; only the
    capturing thread is redirected, and a failed launch still raises."""
    import threading
    from qsvc_tpu_torch.ops import cuda_lib
    cuda_lib.reset_launches()
    record = collections.Counter()
    with cuda_lib.counting_into(record):
        cuda_lib.launched("mc_predict", 0)
        other = threading.Thread(target=cuda_lib.launched,
                                 args=("me_refine", 0))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        with pytest.raises(RuntimeError, match="cudaError 1"):
            cuda_lib.launched("mc_update2", 1)
    cuda_lib.launched("mc_update2", 0)
    assert record == {"mc_predict": 1}
    assert dict(cuda_lib.launches) == {"me_refine": 1, "mc_update2": 1}
    cuda_lib.reset_launches()
