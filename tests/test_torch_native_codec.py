"""The port's native C codec: tests/test_native_codec.py's cases (Python
semantics, the NumPy fallback), its library built into the package's
_build/ directory, and its arrays against the JAX package's codec on seeded
scalars."""

import random

import numpy as np
import pytest

from zerochain_tpu_torch.native import codec


@pytest.fixture(scope="module")
def vals():
    rng = random.Random(123)
    return [rng.randrange(1 << 255) for _ in range(300)] + [
        0, 1, (1 << 255) - 1, 0xFFF, 1 << 252,
    ]


def test_bits_roundtrip(vals):
    bits = codec.scalars_to_bits_np(vals, 255)
    assert bits.shape == (255, len(vals))
    for j in (0, 5, 300, 303, 304):
        v = sum(int(bits[i, j]) << i for i in range(255))
        assert v == vals[j]


def test_limbs_roundtrip(vals):
    limbs = codec.scalars_to_limbs_np(vals, 22)
    assert limbs.shape == (22, len(vals))
    assert codec.limbs_to_scalars(limbs) == vals


def test_fallback_matches_native(vals, monkeypatch):
    if not codec.native_available():
        pytest.skip("no native lib")
    native_bits = codec.scalars_to_bits_np(vals, 255)
    native_limbs = codec.scalars_to_limbs_np(vals, 22)
    monkeypatch.setattr(codec, "_lib", False)
    assert (codec.scalars_to_bits_np(vals, 255) == native_bits).all()
    assert (codec.scalars_to_limbs_np(vals, 22) == native_limbs).all()
    assert codec.limbs_to_scalars(native_limbs) == vals


def test_library_built_into_build_dir():
    if not codec.native_available():
        pytest.skip("no C compiler: the NumPy versions are in use")
    so = codec._target()
    assert so.parent == codec.BUILD_DIR
    assert so.parent.name == "_build" and so.exists()
    assert not list(codec._SRC.parent.glob("*.so"))


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_equals_jax(seed, monkeypatch):
    """Bits, limbs and scalars against the JAX codec on seeded scalars, with
    the port on its C library and on its NumPy versions."""
    from zerochain_tpu.native import codec as jax_codec

    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") >> int(rng.integers(1, 40))
            for _ in range(257)] + [0, 1, (1 << 255) - 1]
    n_bits, n_limbs = (255, 22) if seed == 0 else (256, 23)
    ref_bits = jax_codec.scalars_to_bits_np(vals, n_bits)
    ref_limbs = jax_codec.scalars_to_limbs_np(vals, n_limbs)
    for lib in ((None, False) if codec.native_available() else (False,)):
        monkeypatch.setattr(codec, "_lib", lib)
        assert np.array_equal(codec.scalars_to_bits_np(vals, n_bits), ref_bits)
        limbs = codec.scalars_to_limbs_np(vals, n_limbs)
        assert limbs.dtype == ref_limbs.dtype
        assert np.array_equal(limbs, ref_limbs)
        assert codec.limbs_to_scalars(limbs) == (
            jax_codec.limbs_to_scalars(ref_limbs)) == vals
