"""The MCTF's 5/3 interpolation and decimation of the port
(``ops/dwt2d.interpolate`` / ``decimate``; kernels K6 and K7 in
``csrc/interp.cu`` for CUDA tensors, the plain closed forms here): the
multi-step CPU route against the JAX package's ``upsample2`` /
``downsample2`` composed, the launch wrappers' checks, the kernels' names
against the benchmark's MCTF roofline, and the ``mctf.interp`` regions
of a quarter-pel analysis against the benchmark's schedule.

``tests/test_torch_cuda.py`` holds the kernels to the plain version on
the card."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import interp_roofline, roofline
from qsvc_tpu.ops import dwt2d as jdwt
from qsvc_tpu_torch.config import CodecConfig
from qsvc_tpu_torch.io import synthetic_video
from qsvc_tpu_torch.mctf import transform
from qsvc_tpu_torch.ops import cuda_interp, dwt2d
from qsvc_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: int16 values whose sums and differences wrap: x + nxt, so - ... and
#: se + ... leave the int16 range
WRAPPING = np.array([-32768, -32767, -16385, -1, 0, 1, 16384, 32766,
                     32767], dtype=np.int16)


def _values(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, shape).astype(np.int16)
    if kind == "int16":
        return rng.integers(-2**15, 2**15, shape).astype(np.int16)
    return rng.choice(WRAPPING, shape)


def _jax_steps(fn, x, steps):
    y = jnp.asarray(x)
    for _ in range(steps):
        y = fn(y)
    return np.asarray(y)


@pytest.mark.parametrize("kind", ["u8", "int16", "wrapping"])
@pytest.mark.parametrize("shape", [(2, 5, 7), (1, 1, 1), (3, 2, 16, 24),
                                   (9, 17)])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_interpolate_is_upsample2_composed(steps, shape, kind):
    x = _values(kind, shape, steps)
    got = dwt2d.interpolate([torch.from_numpy(x)], steps)[0]
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_steps(jdwt.upsample2, x, steps))


@pytest.mark.parametrize("kind", ["u8", "int16", "wrapping"])
@pytest.mark.parametrize("shape", [(2, 8, 16), (3, 2, 24, 40), (1, 72)])
@pytest.mark.parametrize("steps", [1, 2, 3])
def test_decimate_is_downsample2_composed(steps, shape, kind):
    x = _values(kind, shape, 10 + steps)
    got = dwt2d.decimate(torch.from_numpy(x), steps)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_steps(jdwt.downsample2, x, steps))


def test_wrapping_values_do_wrap():
    """The wrapping inputs leave the int16 range in the steps' sums (so
    the tests above hold the wrap-around, not just in-range sums)."""
    x = _values("wrapping", (64,), 0).astype(np.int32)
    assert (np.abs(x[:-1] + x[1:]) > 32767).any()


def test_interpolate_two_stacks_each_as_alone():
    """The motion search's step interpolates evens and odds together:
    each as if alone."""
    e = torch.from_numpy(_values("int16", (3, 6, 10), 1))
    o = torch.from_numpy(_values("int16", (2, 6, 10), 2))
    got = dwt2d.interpolate([e, o], 1)
    for g, x in zip(got, (e, o)):
        assert torch.equal(g, dwt2d.upsample2(x))


def test_decimate_of_odd_steps_goes_step_by_step():
    """12 x 20 halves twice evenly, then to 3 x 5: the odd step takes the
    packed analysis, as ``downsample2`` does."""
    x = _values("u8", (2, 12, 20), 3)
    got = dwt2d.decimate(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_steps(jdwt.downsample2, x, 3))


def test_zero_steps_return_the_input():
    x = torch.from_numpy(_values("u8", (2, 4, 6), 4))
    assert dwt2d.interpolate([x], 0)[0] is x
    assert dwt2d.decimate(x, 0) is x


def test_cuda_interp_imports_without_nvcc():
    """The module, and ``dwt2d`` with it, imports where no nvcc is, and
    builds nothing on import."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    code = ("import sys; from qsvc_tpu_torch.ops import cuda_interp, "
            "cuda_lib, dwt2d; assert cuda_lib._lib is None; "
            "assert 'jax' not in sys.modules; print(cuda_interp.MAX_STEPS)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(cuda_interp.MAX_STEPS)


@pytest.mark.parametrize("call,match", [
    (lambda z: cuda_interp.upsample([z], 1), "CUDA"),
    (lambda z: cuda_interp.downsample(z, 1), "CUDA"),
    (lambda z: cuda_interp.upsample([z.int()], 1), "int16"),
    (lambda z: cuda_interp.downsample(z.int(), 2), "int16"),
    (lambda z: cuda_interp.upsample([z], 0), "steps"),
    (lambda z: cuda_interp.upsample([z], cuda_interp.MAX_STEPS + 1),
     "steps"),
    (lambda z: cuda_interp.downsample(z, 4), "steps"),
    (lambda z: cuda_interp.upsample([z, z, z], 1), "stacks"),
    (lambda z: cuda_interp.upsample([z, z[..., :4]], 1), "frames"),
    (lambda z: cuda_interp.downsample(z[..., :6], 3), "halve"),
    (lambda z: cuda_interp.upsample([z[0, 0]], 1), "CUDA"),
    (lambda z: cuda_interp.upsample([z.reshape(-1)], 1), r"\(\.\.\., H, W\)"),
])
def test_wrappers_reject(call, match):
    """A wrapper computes nothing off the card, in another dtype, at
    other step counts or mismatched shapes."""
    z = torch.zeros((2, 3, 8, 8), dtype=torch.int16)
    with pytest.raises(ValueError, match=match):
        call(z)


def test_kernel_names_leave_the_mctf_roofline_alone():
    """The profiler's names of K6 and K7, as their template instances
    show, match no kernel of ``mctf_kernels_roofline``
    (``benchmark.roofline.KERNELS``): its K1-K3 sequence is unchanged."""
    src = open(os.path.join(ROOT, "qsvc_tpu_torch", "csrc",
                            "interp.cu")).read()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                       src)
    assert sorted(names) == ["interp_down_kernel", "interp_up_kernel"]
    for name in names:
        for steps in (1, 2, 3):
            shown = f"(anonymous namespace)::{name}<{steps}>(short const*)"
            assert roofline.kernel_of(shown) is None
            assert not any(part in shown
                           for part in roofline.KERNELS.values())


#: the cell's codec at 128x64, quarter-pel, 2 temporal levels
SUBPEL = dict(pixels_in_x=128, pixels_in_y=64, TRLs=3, GOPs=1, SRLs=3,
              block_size=16, search_range=4, subpixel_accuracy=2)


@pytest.mark.parametrize("a", [1, 2, 3])
def test_interp_regions_are_the_benchmarks_schedule(a):
    """The ``mctf.interp`` spans of a small CPU analysis, keyed by
    (level, part, step), are the regions of
    ``benchmark.interp_roofline.gop_regions`` for that configuration,
    with its samples and bytes: ``interp_roofline`` reads every region
    the program opens, and only those."""
    codec = dict(SUBPEL, subpixel_accuracy=a)
    cfg = CodecConfig(**codec)
    video = synthetic_video(cfg.pictures, cfg.pixels_in_y, cfg.pixels_in_x,
                            seed=5, kind="translate", velocity=(1.25, 2.5))
    log = trace.RunLog()
    trace.set_run_log(log)
    try:
        transform.analyze_jit(*(torch.from_numpy(p) for p in
                                (video.y, video.u, video.v)), cfg)
    finally:
        trace.set_run_log(None)
    got = [(r["level"], r["part"], r.get("step"), r["samples"], r["bytes"])
           for r in log.records if r.get("device_stage") == "mctf.interp"]
    want = [(r["level"], r["part"], r["step"], r["samples"], r["bytes"])
            for r in interp_roofline.gop_regions(codec)]
    assert got == want and len(want) == 2 * (a + 2)
