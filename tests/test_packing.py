"""Wire-format tests: int16 IQ beat words (RspChainTesterUtils.scala:105-109) and
CFAR output words (RspChainVanillaTester.scala:164-172)."""

import numpy as np
import jax.numpy as jnp

from rsp_chains import packing


def test_iq_roundtrip(rng):
    iq = (rng.randint(-(2**15), 2**15, 64) + 1j * rng.randint(-(2**15), 2**15, 64)).astype(np.complex64)
    words = packing.pack_iq(jnp.asarray(iq))
    back = np.asarray(packing.unpack_iq(words))
    np.testing.assert_array_equal(back, iq)


def test_iq_word_layout():
    # real in bits [31:16], imag in [15:0], two's complement
    w = np.asarray(packing.pack_iq(jnp.asarray([3 - 2j], jnp.complex64)))
    assert w[0] == ((3 << 16) | (0x10000 - 2))


def test_cfar_word_roundtrip(rng):
    n = 256
    thr = rng.randint(0, 2**20, n).astype(np.float32)
    pk = rng.randint(0, 2, n).astype(bool)
    words = np.asarray(packing.pack_cfar_words(jnp.asarray(thr), jnp.asarray(pk), 8))
    thr2, bins, pk2 = packing.unpack_cfar_words(words, 8)
    np.testing.assert_array_equal(pk2.astype(bool), pk)
    np.testing.assert_array_equal(bins, np.arange(n))
    np.testing.assert_array_equal(thr2, np.floor(thr).astype(np.uint32) & ((1 << 23) - 1))
