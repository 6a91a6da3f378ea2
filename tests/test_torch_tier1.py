"""PyTorch port: the spec MQ / Tier-1 coder (``codec/mq.py``,
``codec/tier1.py``) against the JAX package's, the T.88 conformance
vector, and the native coder (``codec/fast.py``) against the port's own
spec twin.  Blocks stay small: the spec coder is pure Python."""

import os
import subprocess
import sys

import numpy as np
import pytest

from qsvc_tpu.codec import mq as jmq
from qsvc_tpu.codec import tier1 as jtier1
from qsvc_tpu_torch.codec import fast, mq, tier1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDS = ["LL", "LH", "HL", "HH"]


def _code(path):
    """A module's source after its docstring."""
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    return src[src.index("from __future__"):]


@pytest.mark.parametrize("name", ["mq", "tier1"])
def test_spec_coder_code_is_the_jax_packages(name):
    """The port's copies differ from the JAX package's only in their
    docstrings: one spec coder, one stream format."""
    assert (_code(f"qsvc_tpu_torch/codec/{name}.py")
            == _code(f"qsvc_tpu/codec/{name}.py"))


def test_spec_coder_imports_only_numpy_and_itself():
    code = ("import sys; import qsvc_tpu_torch.codec.tier1;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'qsvc_tpu')];"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _encode(module, bits, ctxs, segments=1):
    enc = module.MQEncoder()
    per = len(bits) // segments
    for s in range(segments):
        for b, cx in zip(bits[s * per:(s + 1) * per],
                         ctxs[s * per:(s + 1) * per]):
            enc.encode(b, cx)
        enc.flush()
    return enc


@pytest.mark.parametrize("n,seed,segments", [(10, 0, 1), (1000, 2, 1),
                                             (3000, 3, 5), (600, 4, 3)])
def test_mq_streams_match_jax(n, seed, segments):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).tolist()
    ctxs = rng.integers(0, mq.N_CONTEXTS, n).tolist()
    enc = _encode(mq, bits, ctxs, segments)
    jenc = _encode(jmq, bits, ctxs, segments)
    assert enc.get_bytes() == jenc.get_bytes()
    assert enc.segment_starts == jenc.segment_starts
    dec = mq.MQDecoder(enc.get_bytes())
    per = n // segments
    for s in range(segments):
        dec.start_segment(enc.segment_starts[s], enc.segment_starts[s + 1])
        assert [dec.decode(cx) for cx in ctxs[s * per:(s + 1) * per]] \
            == bits[s * per:(s + 1) * per], f"segment {s}"


def test_mq_biased_stream_matches_jax():
    rng = np.random.default_rng(7)
    bits = (rng.random(4000) < 0.02).astype(int).tolist()
    ctxs = rng.integers(0, 10, 4000).tolist()
    data = _encode(mq, bits, ctxs).get_bytes()
    assert data == _encode(jmq, bits, ctxs).get_bytes()
    assert len(data) < 4000 / 8 / 2


# ITU-T T.88 Annex H.2 test data (tests/test_mq.py): 256 decisions on one
# context starting at state 0 / MPS 0, and their coded byte stream
_T88_INPUT = bytes.fromhex(
    "00020051000000C00352872AAAAAAAAA82C02000FCD79EF6BF7FED904F46A3BF")
_T88_CODED = bytes.fromhex(
    "84C73BFCE1A1430402200000410DBB86F4317FFF88FF37471ADB6ADFFFAC")


def _t88_bits():
    return [(_T88_INPUT[i // 8] >> (7 - i % 8)) & 1 for i in range(256)]


def test_t88_spec_vector_decoder():
    dec = mq.MQDecoder(_T88_CODED)
    dec.ctx[0] = [0, 0]
    assert [dec.decode(0) for _ in range(256)] == _t88_bits()


def test_t88_spec_vector_encoder_prefix_and_decodability():
    """The guarded flush diverges from the spec's stream after 18 bytes
    (a spec-decodable deviation, see mq.py); the stream still decodes."""
    enc = mq.MQEncoder()
    enc.ctx[0] = [0, 0]
    for b in _t88_bits():
        enc.encode(b, 0)
    enc.flush()
    got = enc.get_bytes()
    assert got[:18] == _T88_CODED[:18]
    dec = mq.MQDecoder(got)
    dec.ctx[0] = [0, 0]
    assert [dec.decode(0) for _ in range(256)] == _t88_bits()


def _coeffs(shape, scale, seed):
    return np.random.default_rng(seed).normal(0, scale, shape
                                              ).astype(np.int64)


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("shape,scale", [((16, 16), 120), ((13, 9), 500),
                                         ((4, 7), 3)])
def test_tier1_streams_match_jax(band, shape, scale):
    c = _coeffs(shape, scale, 10 * BANDS.index(band) + shape[0])
    got = tier1.encode_codeblock(c, band)
    want = jtier1.encode_codeblock(c, band)
    assert (got.data, got.msbs, got.pass_ends) == (want.data, want.msbs,
                                                   want.pass_ends)
    assert got.pass_dist == want.pass_dist and got.dist0 == want.dist0
    for n in range(got.num_passes + 1):
        np.testing.assert_array_equal(
            tier1.decode_codeblock(got.data, got.msbs, n, shape, band,
                                   got.pass_ends),
            jtier1.decode_codeblock(want.data, want.msbs, n, shape, band,
                                    want.pass_ends), err_msg=f"passes={n}")
    np.testing.assert_array_equal(
        tier1.decode_codeblock(got.data, got.msbs, got.num_passes, shape,
                               band, got.pass_ends), c)


def test_tier1_zero_and_sparse_blocks():
    z = tier1.encode_codeblock(np.zeros((8, 8), np.int64), "LL")
    assert (z.data, z.msbs, z.pass_ends) == (b"", 0, [])
    c = np.zeros((16, 16), np.int64)
    c[3, 5], c[12, 1] = 77, -3
    cb = tier1.encode_codeblock(c, "HH")
    np.testing.assert_array_equal(
        tier1.decode_codeblock(cb.data, cb.msbs, cb.num_passes, (16, 16),
                               "HH", cb.pass_ends), c)


def test_native_coder_is_available():
    assert fast.available()


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("shape,scale", [((16, 16), 120), ((13, 9), 500),
                                         ((32, 32), 40), ((4, 7), 3)])
def test_native_encode_matches_tier1(band, shape, scale):
    """``fast.encode_codeblock`` writes the spec twin's bytes, msbs and
    pass ends; the native distortions sum in another order (rtol 1e-9,
    as tests/test_fast_parity.py holds them)."""
    c = _coeffs(shape, scale, 31)
    py = tier1.encode_codeblock(c, band)
    cc = fast.encode_codeblock(c, band)
    assert (cc.data, cc.msbs, cc.pass_ends) == (py.data, py.msbs,
                                                py.pass_ends)
    np.testing.assert_allclose(cc.pass_dist, py.pass_dist, rtol=1e-9,
                               atol=1e-6)
    assert cc.dist0 == pytest.approx(py.dist0)
    assert isinstance(cc, tier1.CodeblockStream)


@pytest.mark.parametrize("band", ["LH", "HH"])
def test_native_decode_matches_tier1_at_every_truncation(band):
    c = _coeffs((24, 24), 200, 5)
    cb = tier1.encode_codeblock(c, band)
    for n in range(cb.num_passes + 1):
        np.testing.assert_array_equal(
            fast.decode_codeblock(cb.data, cb.msbs, n, cb.shape, band,
                                  cb.pass_ends),
            tier1.decode_codeblock(cb.data, cb.msbs, n, cb.shape, band,
                                   cb.pass_ends), err_msg=f"passes={n}")


def test_native_batch_matches_single():
    tiles = [_coeffs((16, 16), 100, s) for s in range(8)]
    bands = BANDS * 2
    batch = fast.encode_codeblocks_batch(tiles, bands)
    for t, b, cb in zip(tiles, bands, batch):
        single = fast.encode_codeblock(t, b)
        assert (cb.data, cb.pass_ends) == (single.data, single.pass_ends)
        np.testing.assert_array_equal(
            fast.decode_codeblock(cb.data, cb.msbs, cb.num_passes, cb.shape,
                                  b, cb.pass_ends), t)


def test_available_reports_a_failed_build(monkeypatch):
    """``available`` is False when the library cannot be built; the
    coder functions then raise (no fallback to the spec twin)."""
    def broken():
        raise RuntimeError("building the native EBCOT coder failed")
    monkeypatch.setattr(fast, "_build", broken)
    monkeypatch.setattr(fast, "_lib", None)
    assert not fast.available()
    with pytest.raises(RuntimeError):
        fast.encode_codeblock(np.ones((4, 4), np.int64), "LL")
