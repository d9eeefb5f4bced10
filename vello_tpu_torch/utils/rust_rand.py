"""Bit-exact reproduction of Rust's ``rand::rngs::StdRng`` stream.

The reference's randomized test scenes (``test_scenes.rs`` many_clips etc.)
seed ``StdRng::seed_from_u64(..)`` — reproducing the exact sequence here
lets our ports diff against the reference's golden PNGs pixel-for-pixel.

Implements:
- ``seed_from_u64``: rand_core's PCG32-based default expansion
- ChaCha12 block stream (djb layout: 64-bit counter words 12-13,
  64-bit stream id words 14-15), rand_chacha's sequential word order
- ``random_f32/f64`` (StandardUniform) and ``random_range_f64``
  (UniformFloat sample_single) with rand 0.9's float formulas
"""

from __future__ import annotations

import struct

_M32 = 0xFFFFFFFF


def _seed_from_u64(state: int) -> bytes:
    """rand_core::SeedableRng::seed_from_u64 (PCG32 expansion)."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = b""
    for _ in range(8):
        state = (state * MUL + INC) & 0xFFFFFFFFFFFFFFFF
        xorshifted = (((state >> 18) ^ state) >> 27) & _M32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _M32
        out += struct.pack("<I", x)
    return out


def _qr(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & _M32
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & _M32


def _chacha_block(key_words, counter, rounds=12):
    s = ([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
         + list(key_words)
         + [counter & _M32, (counter >> 32) & _M32, 0, 0])
    w = list(s)
    for _ in range(rounds // 2):
        _qr(w, 0, 4, 8, 12)
        _qr(w, 1, 5, 9, 13)
        _qr(w, 2, 6, 10, 14)
        _qr(w, 3, 7, 11, 15)
        _qr(w, 0, 5, 10, 15)
        _qr(w, 1, 6, 11, 12)
        _qr(w, 2, 7, 8, 13)
        _qr(w, 3, 4, 9, 14)
    return [(w[i] + s[i]) & _M32 for i in range(16)]


class StdRng:
    """rand 0.9 StdRng (= ChaCha12Rng) seeded via seed_from_u64."""

    def __init__(self, seed_u64: int):
        seed = _seed_from_u64(seed_u64)
        self._key = struct.unpack("<8I", seed)
        self._counter = 0
        self._buf: list = []

    def _next_word(self) -> int:
        if not self._buf:
            self._buf = _chacha_block(self._key, self._counter)
            self._counter += 1
        return self._buf.pop(0)

    def next_u32(self) -> int:
        return self._next_word()

    def next_u64(self) -> int:
        lo = self._next_word()
        hi = self._next_word()
        return lo | (hi << 32)

    # --- rand 0.9 StandardUniform ---
    def random_f32(self) -> float:
        return (self.next_u32() >> 8) * (1.0 / (1 << 24))

    def random_f64(self) -> float:
        return (self.next_u64() >> 11) * (1.0 / (1 << 53))

    # --- rand 0.9 UniformFloat::<f64>::sample_single (low..high) ---
    def random_range_f64(self, low: float, high: float) -> float:
        scale = high - low
        while True:
            value1_2 = struct.unpack(
                "<d", struct.pack("<Q",
                                  0x3FF0000000000000
                                  | (self.next_u64() >> 12)))[0]
            res = (value1_2 - 1.0) * scale + low
            if res < high:
                return res
