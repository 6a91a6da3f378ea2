"""PyTorch port: the GOP-sharded MCTF and the two distributed encodes
(``qsvc_tpu_torch/parallel``) against the JAX package's SEQUENTIAL
functions (CPU, exact: every path here is integer).

The multi-rank cases run real ``gloo`` process groups of 2 and 4 worker
processes (one spawn per world size, a ``file://`` store in a temp dir).
The workers import only the port; the JAX references are computed here
and handed over as numpy arrays.  The 4-rank ring is the smallest that
catches a wrong neighbour index in the halo exchange (with 2 ranks the
left and right neighbours coincide)."""

import functools
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qsvc_tpu import api as japi
from qsvc_tpu.config import CodecConfig as JaxConfig
from qsvc_tpu.io import synthetic_video
from qsvc_tpu.mctf import transform as jtransform
from qsvc_tpu.mctf import update as jupdate
from qsvc_tpu.ops import dwt2d as jdwt2d
from qsvc_tpu.parallel import mesh as jmesh
from qsvc_tpu_torch.codec import fast
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.mctf import update
from qsvc_tpu_torch.parallel import distributed as pdist
from qsvc_tpu_torch.parallel import mesh as pmesh
from qsvc_tpu_torch.parallel import transform as ptransform

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_parallel.py's configuration: 32x32, TRLs 2, bs 16, sr 2
KW = dict(pixels_in_x=32, pixels_in_y=32, TRLs=2, block_size=16,
          search_range=2, update_factor=0.25, quantization_texture=0,
          SRLs=2)
# (world size, case) -> (GOPs, TRLs, sub-pixel accuracy); "k2" holds two
# GOPs per rank.  "t3" has two temporal levels: only there does the
# phase-2 halo (the right boundary copy) feed later work, the next level's
# analysis.  "a1": half-pixel vectors, which the update (K4 on the card)
# takes shifted down by the accuracy.
SPAWN_CASES = {(2, "k1"): (2, 2, 0), (2, "k2"): (4, 2, 0),
               (2, "a1"): (2, 2, 1), (4, "k1"): (4, 2, 0),
               (4, "t3"): (4, 3, 0)}


def _video(G, TRLs=2):
    return synthetic_video(JaxConfig(GOPs=G, **dict(KW, TRLs=TRLs)).pictures,
                           32, 32, seed=10 + G)


def _kw(TRLs=2, a=0):
    return dict(KW, TRLs=TRLs, subpixel_accuracy=a)


@functools.cache
def _jax_ref(G, TRLs=2, a=0):
    """JAX sequential analyze/synthesize/compress/compress_gops of the
    G-GOP test video, as numpy and bytes."""
    cfg = JaxConfig(GOPs=G, **_kw(TRLs, a))
    vid = _video(G, TRLs)
    seq_bytes = japi.compress(vid, cfg, reversible=True).to_bytes()
    # the jitted analysis on the uint8 planes api.compress uploads (its
    # compiled program, reused); analyze casts to int16 first
    st = jtransform.analyze_jit(*(jnp.asarray(p) for p in vid.planes()), cfg)
    rec = jtransform.synthesize_jit(st, cfg)
    return dict(
        stream=dict(low=[np.asarray(p) for p in
                         (st.low_y, st.low_u, st.low_v)],
                    levels=[[np.asarray(a) for a in lev]
                            for lev in st.levels]),
        rec=[np.asarray(p) for p in rec],
        bytes=seq_bytes,
        gops=[s.to_bytes() for s in
              japi.compress_gops(vid, cfg, reversible=True)])


def _assert_stream_equal(got, want):
    """A port MCTFStream (numpy) against the JAX reference dict."""
    for a, b in zip((got.low_y, got.low_u, got.low_v), want["low"]):
        np.testing.assert_array_equal(a, b)
    assert len(got.levels) == len(want["levels"])
    for t, (lev, ref) in enumerate(zip(got.levels, want["levels"])):
        for a, b, name in zip(lev, ref, ("hy", "hu", "hv", "mv", "is_B")):
            np.testing.assert_array_equal(a, b, err_msg=f"level {t} {name}")


# ------------------------------------------------------------ (a) sharding

@pytest.mark.parametrize("gop_size,frames", [(2, 5), (4, 9), (4, 17)])
def test_shard_gops_match_jax(gop_size, frames):
    x = np.random.default_rng(frames).integers(0, 256, (frames, 4, 6))
    got = pmesh.shard_gops(x, gop_size)
    np.testing.assert_array_equal(got, jmesh.shard_gops(x, gop_size))
    assert got.shape == ((frames - 1) // gop_size, gop_size + 1, 4, 6)
    np.testing.assert_array_equal(pmesh.unshard_gops(got), x)
    np.testing.assert_array_equal(pmesh.unshard_gops(got),
                                  jmesh.unshard_gops(got))


def test_mesh_without_process_group_is_rank_0_of_1():
    m = pmesh.make_mesh("cpu")
    assert (m.rank, m.size, m.device, m.group) == (0, 1,
                                                   torch.device("cpu"), None)
    assert pdist.make_gop_mesh("cpu") == m


# --------------------------------------------------- (b) the K4 plain path

@pytest.mark.parametrize("bs,sr", [(16, 4), (16, 16), (8, 12)])
def test_update_fields_batch_matches_jax(bs, sr):
    """One direction of the accumulated update, |mv| up to sr + 1 (what
    motion estimation returns), bit for bit against the JAX lax path."""
    rng = np.random.default_rng(bs * 100 + sr)
    P, C, By, Bx = 3, 3, 4, 5
    res = rng.integers(-128, 128, (P, C, By * bs, Bx * bs)).astype(np.int16)
    mvy, mvx = (rng.integers(-sr - 1, sr + 2, (P, By, Bx)).astype(np.int32)
                for _ in range(2))
    got = update.update_fields_batch(torch.from_numpy(res),
                                     torch.from_numpy(mvy),
                                     torch.from_numpy(mvx), bs, 0.25, sr)
    want = jupdate.update_fields_batch(jnp.asarray(res), jnp.asarray(mvy),
                                       jnp.asarray(mvx), bs, 0.25, sr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- (c) one process, k = G GOPs

def test_single_process_sharded_transform_matches_jax_sequential():
    G = 2
    cfg = CodecConfig(GOPs=G, **KW)
    mesh = pmesh.make_mesh("cpu")
    planes = pdist.shard_video_gops(_video(G), cfg, mesh)
    st = ptransform.analyze_sharded(*planes, cfg, mesh)
    ref = _jax_ref(G)
    _assert_stream_equal(st.to_numpy(), ref["stream"])
    rec = ptransform.synthesize_sharded(st, cfg, mesh)
    for a, b in zip(rec, ref["rec"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_single_process_encode_step_matches_jax():
    """Sharded MCTF + packed 5/3 DWT of every subband frame."""
    G = 2
    cfg = CodecConfig(GOPs=G, **KW)
    mesh = pmesh.make_mesh("cpu")
    out = ptransform.encode_step_sharded(
        *pdist.shard_video_gops(_video(G), cfg, mesh), cfg, mesh)
    ref = _jax_ref(G)["stream"]

    def dwt(x):
        return np.asarray(jdwt2d.analyze(jnp.asarray(x) - 128, cfg.SRLs - 1,
                                         "5/3"))
    for a, b in zip(out["low"], ref["low"]):
        np.testing.assert_array_equal(a.numpy(), dwt(b))
    assert len(out["levels"]) == cfg.TRLs - 1
    for got, lev in zip(out["levels"], ref["levels"]):
        for a, b in zip(got[:3], lev[:3]):
            np.testing.assert_array_equal(a.numpy(), dwt(b))
        np.testing.assert_array_equal(got[3].numpy(), lev[3])
        np.testing.assert_array_equal(got[4].numpy(), lev[4])


@pytest.mark.parametrize("G", [2, 4])
def test_single_process_encodes_match_jax(G):
    cfg = CodecConfig(GOPs=G, **KW)
    mesh = pmesh.make_mesh("cpu")
    vid = _video(G)
    ref = _jax_ref(G)
    assert pdist.compress_distributed(vid, cfg, mesh, reversible=True
                                      ).to_bytes() == ref["bytes"]
    assert pdist.encode_gops_distributed(vid, cfg, mesh,
                                         reversible=True) == ref["gops"]


# ------------------------------------------------------- (f) bad splits

@pytest.mark.parametrize("fn", ["shard_video_gops", "encode_gops_distributed",
                                "compress_distributed"])
def test_uneven_gop_split_raises(fn):
    """4 GOPs over 3 ranks (checked before any communication)."""
    cfg = CodecConfig(GOPs=4, **KW)
    mesh = pmesh.GopMesh(rank=0, size=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="split evenly"):
        getattr(pdist, fn)(_video(4), cfg, mesh)


def test_intra_only_distributed_encode_raises():
    cfg = CodecConfig(**dict(KW, TRLs=1))
    with pytest.raises(ValueError, match="TRLs"):
        pdist.compress_distributed(_video(2), cfg, pmesh.make_mesh("cpu"))


# ------------------------------------ (d), (e) real multi-rank process groups

_WORKER = r"""
import os, pickle, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.mctf.transform import MCTFStream
from qsvc_tpu_torch.parallel import distributed as pdist
from qsvc_tpu_torch.parallel import transform as ptransform

repo, rank, world, store, inp, outdir = sys.argv[1:7]
rank, world = int(rank), int(world)
pdist.initialize("cpu", init_method="file://" + store, world_size=world,
                 rank=rank)
mesh = pdist.make_gop_mesh("cpu")
assert (mesh.rank, mesh.size) == (rank, world), mesh
with open(inp, "rb") as f:
    cases = pickle.load(f)


def chunk_of(stream, cfg, k):
    # this rank's chunk of a sequential stream: level t keeps k*(S>>t)
    # high frames per rank, the low band k*(S>>(T-1)) + 1 frames
    S, T = cfg.gop_size, cfg.TRLs
    levels = []
    for t, lev in enumerate(stream["levels"], start=1):
        n = k * (S >> t)
        levels.append(tuple(a[rank * n:(rank + 1) * n] for a in lev))
    n = k * (S >> (T - 1))
    low = [a[rank * n:(rank + 1) * n + 1] for a in stream["low"]]
    return MCTFStream.from_numpy(MCTFStream(*low, tuple(levels)),
                                device="cpu")


out = {}
for name, (kw, G, jstream) in cases.items():
    cfg = CodecConfig(GOPs=G, **kw)
    vid = synthetic_video(cfg.pictures, 32, 32, seed=10 + G)
    planes = pdist.shard_video_gops(vid, cfg, mesh)
    st = ptransform.analyze_sharded(*planes, cfg, mesh)
    rec = ptransform.synthesize_sharded(st, cfg, mesh)
    jrec = ptransform.synthesize_sharded(
        chunk_of(jstream, cfg, G // world), cfg, mesh)
    out[name] = dict(
        stream=st.to_numpy(), rec=[p.numpy() for p in rec],
        jrec=[p.numpy() for p in jrec],
        bytes=pdist.compress_distributed(vid, cfg, mesh,
                                         reversible=True).to_bytes(),
        gops=pdist.encode_gops_distributed(vid, cfg, mesh, reversible=True))
with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
pdist.end_group()
"""


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """``spawn(world)``: the per-rank results of one gloo group of
    ``world`` ranks, run on first use."""
    done = {}

    def run(world):
        if world in done:
            return done[world]
        fast.build_seconds()        # build the native coder once, here
        d = tmp_path_factory.mktemp(f"gloo{world}")
        script = d / "worker.py"
        script.write_text(_WORKER)
        cases = {name: (_kw(T, a), G, _jax_ref(G, T, a)["stream"])
                 for (w, name), (G, T, a) in SPAWN_CASES.items()
                 if w == world}
        with open(d / "in.pkl", "wb") as f:
            pickle.dump(cases, f)
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT")}
        env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, str(script), REPO, str(r), str(world),
             str(d / "store"), str(d / "in.pkl"), str(d)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(world)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=240)
                if p.returncode != 0:
                    errs.append(err[-3000:])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert not errs, "\n".join(errs)
        res = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                res.append(pickle.load(f))
        done[world] = res
        return res
    return run


SPAWN_IDS = sorted(SPAWN_CASES)


@pytest.mark.parametrize("world,case", SPAWN_IDS)
def test_multirank_analyze_matches_jax_sequential(spawn, world, case):
    """Per-rank high bands and vectors, concatenated, and the per-rank
    low bands, unsharded, equal the JAX sequential analysis."""
    ranks = [r[case]["stream"] for r in spawn(world)]
    ref = _jax_ref(*SPAWN_CASES[world, case])["stream"]
    for t, want in enumerate(ref["levels"]):
        for i, name in enumerate(("hy", "hu", "hv", "mv", "is_B")):
            got = np.concatenate([st.levels[t][i] for st in ranks])
            np.testing.assert_array_equal(got, want[i],
                                          err_msg=f"level {t} {name}")
    for i, name in enumerate(("low_y", "low_u", "low_v")):
        got = pmesh.unshard_gops(np.stack([st[i] for st in ranks]))
        np.testing.assert_array_equal(got, ref["low"][i], err_msg=name)


@pytest.mark.parametrize("world,case", SPAWN_IDS)
@pytest.mark.parametrize("source", ["rec", "jrec"])
def test_multirank_synthesize_matches_jax_sequential(spawn, world, case,
                                                     source):
    """Sharded synthesis of the ranks' own streams ("rec") and of the
    JAX-encoded sequential stream cut into chunks ("jrec") equals the
    JAX sequential synthesis."""
    ranks = [r[case][source] for r in spawn(world)]
    ref = _jax_ref(*SPAWN_CASES[world, case])["rec"]
    for i, name in enumerate("yuv"):
        got = pmesh.unshard_gops(np.stack([planes[i] for planes in ranks]))
        np.testing.assert_array_equal(got, ref[i], err_msg=name)


@pytest.mark.parametrize("world,case", SPAWN_IDS)
def test_multirank_compress_distributed_matches_jax(spawn, world, case):
    ref = _jax_ref(*SPAWN_CASES[world, case])["bytes"]
    for r, res in enumerate(spawn(world)):
        assert res[case]["bytes"] == ref, f"rank {r}"


@pytest.mark.parametrize("world,case", SPAWN_IDS)
def test_multirank_encode_gops_matches_jax(spawn, world, case):
    ref = _jax_ref(*SPAWN_CASES[world, case])["gops"]
    for r, res in enumerate(spawn(world)):
        assert res[case]["gops"] == ref, f"rank {r}"


# ------------------------------------------------- (g) the scaling harness

SCALING_KW = dict(pixels_in_x=32, pixels_in_y=32, TRLs=2, block_size=16,
                  search_range=2, update_factor=0.25, SRLs=2)


def test_measure_scaling_two_gloo_ranks(monkeypatch):
    """Both points run (one rank, then a gloo group of two spawned
    processes); no efficiency floor: under parallel test workers the
    host's cores are shared and the timing is noise."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = CodecConfig(**SCALING_KW)
    res = pdist.measure_scaling(2, reps=1, cfg=cfg, device="cpu")
    assert set(res) == {"n_devices", "fps_1", "fps_n", "efficiency",
                        "launches", "points"}
    assert res["n_devices"] == 2
    assert res["fps_1"] > 0 and res["fps_n"] > 0
    assert res["efficiency"] == pytest.approx(
        res["fps_n"] / (2 * res["fps_1"]))
    # CPU ranks run the plain versions: no kernel launches
    assert res["launches"] == {1: {}, 2: {}}
    one, two = res["points"][1], res["points"][2]
    assert one["rank_halo_bytes"] == [0] and len(one["rank_seconds"]) == 1
    # one temporal level: each rank sends one int16 4:4:4 frame and
    # receives one per call
    assert two["rank_halo_bytes"] == [2 * 3 * 32 * 32 * 2] * 2
    assert len(two["rank_seconds"]) == 2
    assert all(s >= 0 for s in two["rank_halo_seconds"])


@pytest.mark.parametrize("n", [1, 2])
def test_measure_scaling_never_shares_a_card(n):
    """More CUDA ranks than cards raise before any process starts (here
    there is no card at all): no rank shares a card, none falls back to
    gloo."""
    if torch.cuda.device_count() >= n:
        pytest.skip("needs fewer cards than ranks")
    with pytest.raises(ValueError, match="one rank per card"):
        pdist.measure_scaling(n, cfg=CodecConfig(**SCALING_KW),
                              device="cuda")


def test_scaling_command_writes_the_sweep(monkeypatch, tmp_path):
    from qsvc_tpu_torch.parallel import scaling
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(pdist, "SCALING_CONFIG", CodecConfig(**SCALING_KW))
    out = tmp_path / "scaling.json"
    assert scaling.main(["--ns", "2", "--reps", "1", "--device", "cpu",
                         "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert [p["n"] for p in res["points"]] == [1, 2]
    assert res["points"][0]["efficiency"] == 1.0
    assert res["config"]["pixels_in_x"] == 32 and res["cards"] is None


def _fail_on_rank_1(rank, n, store):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(600)                 # a peer that would wait for rank 1


def test_run_ranks_stops_the_peers_of_a_failed_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ranks failed"):
        pdist.run_ranks(_fail_on_rank_1, 2, timeout=120)
    assert time.monotonic() - t0 < 60


# ------------------------------------------- (h) halo payloads, teardown

def _shift_rank(rank, n, store, host_staged):
    """Both shifts of an int16 and an int32 frame with negative values;
    returns what arrived and the run log's halo totals."""
    import dataclasses

    from qsvc_tpu_torch.utils import trace
    pdist.initialize("cpu", init_method=f"file://{store}", world_size=n,
                     rank=rank)
    mesh = dataclasses.replace(pdist.make_gop_mesh("cpu"),
                               host_staged=host_staged)
    log = trace.RunLog()
    trace.set_run_log(log)
    out = {}
    try:
        for dtype in (np.int16, np.int32):
            x = torch.from_numpy(_halo_frame(rank, dtype))
            for step in (1, -1):
                got = ptransform._shift(x, mesh, step)
                out[dtype.__name__, step] = None if got is None else (
                    str(got.dtype), got.numpy())
    finally:
        trace.set_run_log(None)
    halo = pmesh.halo_totals(log.records)
    out["log"] = (halo["exchanges"], halo["sent"], halo["received"],
                  halo["seconds"])
    pdist.end_group()
    return out


def _halo_frame(rank, dtype):
    info = np.iinfo(dtype)
    return np.random.default_rng(rank).integers(
        info.min, info.max, (3, 6, 10), endpoint=True).astype(dtype)


@pytest.mark.parametrize("host_staged", [True, False])
def test_shift_payload_round_trips_int16_and_int32(host_staged):
    """The halo travels as its bytes (nccl takes no int16 tensor): both
    shifts give each rank its neighbour's frame bit for bit, negative
    values and dtype included, staged through host memory or not."""
    ranks = pdist.run_ranks(_shift_rank, 2, host_staged, timeout=120)
    for dtype in (np.int16, np.int32):
        name = dtype.__name__
        assert ranks[0][name, 1] is None and ranks[1][name, -1] is None
        for r, step, src in ((1, 1, 0), (0, -1, 1)):
            got_dtype, got = ranks[r][name, step]
            assert got_dtype == str(torch.from_numpy(got).dtype)
            assert got.dtype == dtype
            np.testing.assert_array_equal(got, _halo_frame(src, dtype))
    # each rank sent 2 frames and received 2 (one of each dtype)
    nbytes = sum(_halo_frame(0, d).nbytes for d in (np.int16, np.int32))
    for exchanges, sent, received, seconds in (r["log"] for r in ranks):
        assert (exchanges, sent, received) == (4, nbytes, nbytes)
        assert seconds >= 0


def _end_group_rank(rank, n, store):
    pdist.initialize("cpu", init_method=f"file://{store}", world_size=n,
                     rank=rank)
    mesh = pdist.make_gop_mesh("cpu")
    x = torch.full((2, 4), rank, dtype=torch.int16)
    got = ptransform._shift(x, mesh, 1)
    blobs = pdist._allgather_indexed_bytes([(rank, bytes([rank]))], n, mesh)
    pdist.end_group()
    pdist.end_group()                 # a second call does nothing
    return (None if got is None else int(got[0, 0]), blobs,
            torch.distributed.is_initialized())


@pytest.mark.parametrize("n", [2, 4])
def test_end_group_ends_every_rank(n):
    """Every rank leaves its group through ``end_group`` and exits 0
    (``run_ranks`` raises on any other exit)."""
    ranks = pdist.run_ranks(_end_group_rank, n, timeout=120)
    for r, (got, blobs, still) in enumerate(ranks):
        assert got == (None if r == 0 else r - 1)
        assert blobs == [bytes([i]) for i in range(n)]
        assert not still


# ------------------------------------------- (i) the encodes without a mesh

def _default_mesh_rank(rank, n, store, G):
    pdist.initialize("cpu", init_method=f"file://{store}", world_size=n,
                     rank=rank)
    cfg = CodecConfig(GOPs=G, **KW)
    vid = _video(G)
    data = pdist.compress_distributed(vid, cfg, reversible=True).to_bytes()
    gops = pdist.encode_gops_distributed(vid, cfg, reversible=True)
    pdist.end_group()
    return data, gops


def test_encodes_without_a_mesh_use_the_default_group():
    """``mesh=None``, as the JAX calls leave it: the mesh of the default
    process group (here 2 gloo ranks); without a group, an error."""
    vid, cfg = _video(2), CodecConfig(GOPs=2, **KW)
    for fn in (pdist.compress_distributed, pdist.encode_gops_distributed):
        with pytest.raises(RuntimeError, match="no process group"):
            fn(vid, cfg)
    ref = _jax_ref(2)
    for data, gops in pdist.run_ranks(_default_mesh_rank, 2, 2,
                                      timeout=300):
        assert data == ref["bytes"] and gops == ref["gops"]
