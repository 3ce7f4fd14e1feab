"""Port RNG (raytracer0_tpu_torch.rng) against the JAX package's RNG on numpy.

The counter RNG is integer math, so the port must be bitwise equal: every
comparison here is exact.
"""

import os

import numpy as np
import pytest
import torch

from raytracer0_tpu import rng as jrng
from raytracer0_tpu_torch import rng as trng

# pytest-xdist runs the test files in worker processes that share the
# cores: one torch thread each, or their intra-op pools oversubscribe them
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

_U32_MAX = 2**32 - 1


def _grid():
    """Broadcastable uint32 coordinate grid, edges near 2**32 included."""
    r = np.random.default_rng(1234)
    pix = np.concatenate([
        np.array([0, 1, 2, 2**31 - 1, 2**31, _U32_MAX - 1, _U32_MAX], np.uint32),
        r.integers(0, 2**32, size=25, dtype=np.uint64).astype(np.uint32)])
    pas = np.array([0, 1, 7, 2**31, _U32_MAX], np.uint32)
    depth = np.array([0, 3, 11, _U32_MAX], np.uint32)
    return pix[:, None, None], pas[None, :, None], depth[None, None, :]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("stream", list(jrng.Stream))
def test_draws_bitwise_equal(stream):
    pix, pas, depth = _grid()
    samp, slot = 3, 2
    coords_np = (pix, pas, samp, depth, slot, int(stream))
    coords_t = (_t(pix), _t(pas), samp, _t(depth), slot, int(stream))

    np.testing.assert_array_equal(
        trng.fold(*coords_t).numpy(), jrng.fold(*coords_np, xp=np).astype(np.int64))
    np.testing.assert_array_equal(
        trng.uniform(*coords_t).numpy(), jrng.uniform(*coords_np, xp=np))
    for a, b in zip(trng.uniform2(*coords_t), jrng.uniform2(*coords_np, xp=np)):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(trng.uniform3(*coords_t), jrng.uniform3(*coords_np, xp=np)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert trng.uniform(*coords_t).dtype == torch.float32


def test_pcg_bitwise_equal():
    pix, _, _ = _grid()
    np.testing.assert_array_equal(
        trng.pcg(_t(pix)).numpy(), jrng.pcg(pix, xp=np).astype(np.int64))


@pytest.mark.parametrize("h,w,row0", [(8, 128, 0), (24, 24, 0), (5, 7, 3),
                                      (3, 65536, 65535)])
def test_pixel_ids(h, w, row0):
    ref = jrng.pixel_ids(h, w, xp=np, row0=row0).astype(np.int64)
    out = trng.pixel_ids(h, w, row0=row0)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)


def test_stream_values_match_jax():
    assert {s.name: int(s) for s in trng.Stream} == \
        {s.name: int(s) for s in jrng.Stream}


def test_noise_lut_bitwise_equal():
    np.testing.assert_array_equal(trng.noise_lut().numpy(), jrng.noise_lut())
