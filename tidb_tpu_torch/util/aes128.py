"""Pure-python AES-128 ECB block ops: fallback for MySQL AES_ENCRYPT /
AES_DECRYPT when the `cryptography` package is absent from the image.

MySQL's key folding (expression/builtins_ext.py) always produces a
16-byte key, so only AES-128 is needed. This is a straight FIPS-197
implementation — table-driven S-box built from the GF(2^8) inverse plus
the affine map, so no 256-constant blob to get subtly wrong; verified
against the FIPS-197 appendix vector and the JAX package's copy in
tests/test_torch_builtins.py.
Performance is irrelevant here (a per-row SQL builtin on a mock store),
correctness and zero dependencies are the point.
"""

from __future__ import annotations

__all__ = ["encrypt_block", "decrypt_block"]

# -- GF(2^8) tables -----------------------------------------------------------

_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    # multiply by the generator 0x03 = x * 2 ^ x
    _x ^= (_x << 1) ^ (0x11B if _x & 0x80 else 0)
    _x &= 0xFF
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gmul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _rotl8(b: int, n: int) -> int:
    return ((b << n) | (b >> (8 - n))) & 0xFF


_SBOX = [0] * 256
for _i in range(256):
    _inv = 0 if _i == 0 else _EXP[255 - _LOG[_i]]
    _SBOX[_i] = (_inv ^ _rotl8(_inv, 1) ^ _rotl8(_inv, 2) ^
                 _rotl8(_inv, 3) ^ _rotl8(_inv, 4) ^ 0x63)
_INV_SBOX = [0] * 256
for _i, _v in enumerate(_SBOX):
    _INV_SBOX[_v] = _i

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _expand_key(key: bytes) -> list[list[int]]:
    """16-byte key -> 11 round keys of 16 ints each."""
    if len(key) != 16:
        raise ValueError("AES-128 needs a 16-byte key")
    words = [list(key[i:i + 4]) for i in range(0, 16, 4)]
    for i in range(4, 44):
        w = list(words[i - 1])
        if i % 4 == 0:
            w = [_SBOX[w[1]] ^ _RCON[i // 4 - 1], _SBOX[w[2]],
                 _SBOX[w[3]], _SBOX[w[0]]]
        words.append([a ^ b for a, b in zip(words[i - 4], w)])
    return [sum(words[4 * r:4 * r + 4], []) for r in range(11)]


def _shift_rows(s: list[int]) -> list[int]:
    # state is column-major (FIPS-197): byte r + 4c
    return [s[(i + 4 * (i % 4)) % 16] for i in range(16)]


def _inv_shift_rows(s: list[int]) -> list[int]:
    return [s[(i - 4 * (i % 4)) % 16] for i in range(16)]


def _mix_columns(s: list[int], inv: bool) -> list[int]:
    out = [0] * 16
    m = ((14, 11, 13, 9) if inv else (2, 3, 1, 1))
    for c in range(4):
        col = s[4 * c:4 * c + 4]
        for r in range(4):
            out[4 * c + r] = (_gmul(col[0], m[(0 - r) % 4]) ^
                              _gmul(col[1], m[(1 - r) % 4]) ^
                              _gmul(col[2], m[(2 - r) % 4]) ^
                              _gmul(col[3], m[(3 - r) % 4]))
    return out


def encrypt_block(key: bytes, block: bytes) -> bytes:
    if len(block) != 16:
        raise ValueError("AES block must be 16 bytes")
    rk = _expand_key(key)
    s = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 10):
        s = [_SBOX[b] for b in s]
        s = _shift_rows(s)
        s = _mix_columns(s, inv=False)
        s = [b ^ k for b, k in zip(s, rk[rnd])]
    s = [_SBOX[b] for b in s]
    s = _shift_rows(s)
    return bytes(b ^ k for b, k in zip(s, rk[10]))


def decrypt_block(key: bytes, block: bytes) -> bytes:
    if len(block) != 16:
        raise ValueError("AES block must be 16 bytes")
    rk = _expand_key(key)
    s = [b ^ k for b, k in zip(block, rk[10])]
    for rnd in range(9, 0, -1):
        s = _inv_shift_rows(s)
        s = [_INV_SBOX[b] for b in s]
        s = [b ^ k for b, k in zip(s, rk[rnd])]
        s = _mix_columns(s, inv=True)
    s = _inv_shift_rows(s)
    s = [_INV_SBOX[b] for b in s]
    return bytes(b ^ k for b, k in zip(s, rk[0]))
