"""Faults planted under a run by the fault tests (``run.main(...,
fault="benchmark.tests.faults:<name>")``): each breaks the program the way
a wrong optimisation could, in the rank process, before its set-up.
Each takes the rank's index."""


def update_unchanged(rank):
    """The MCTF update step returns the frames it was given."""
    from qsvc_tpu_torch.mctf import update
    update.apply_update = lambda even, upd, sign: even.clone()


def half_batch(rank):
    """The texture stack codes its first half; the second half is left
    out, its planes those of the first half's mean."""
    from qsvc_tpu_torch.codec import frame_codec
    orig = frame_codec.encode_frames_dispatch_sparse

    def dispatch(planes, *args, **kwargs):
        n = planes.shape[0]
        planes = planes.clone()
        if n > 1:
            keep = planes[:n // 2 or 1]
            planes[n // 2 or 1:] = keep.float().mean(0).to(planes.dtype)
        return orig(planes, *args, **kwargs)
    frame_codec.encode_frames_dispatch_sparse = dispatch


def no_exchange(rank):
    """The halo exchange between ranks does nothing."""
    from qsvc_tpu_torch.parallel import transform
    transform._shift = lambda x, mesh, step: None


def altered_answer(rank):
    """Every stream the encode finishes has one byte of its first coded
    block flipped."""
    from qsvc_tpu_torch import api
    orig = api.compress_finish

    def finish(pending):
        vs = orig(pending)
        for fr in vs.low:
            for ef in fr.values():
                for b in ef.blocks:
                    if b.data:
                        b.data = bytes([b.data[0] ^ 0x5A]) + b.data[1:]
                        return vs
        return vs
    api.compress_finish = finish


def rank1_fails(rank):
    """Rank 1 raises in its third sharded encode call (inside the
    window)."""
    if rank != 1:
        return
    from qsvc_tpu_torch.parallel import distributed
    orig = distributed.compress_distributed
    calls = [0]

    def call(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("rank 1 fails")
        return orig(*args, **kwargs)
    distributed.compress_distributed = call
