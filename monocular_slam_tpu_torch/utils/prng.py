"""`jax.random`'s threefry generator in numpy, bit for bit.

The JAX package draws its synthetic data (the renderer's textures, the
feature sequences) from `jax.random` keys. This module holds the same rules
so that the port makes the same data from the same seed without JAX:

- a key is a (2,) uint32 array; `PRNGKey(seed)` is `[0, seed]` for a
  32-bit seed (`threefry_seed`);
- `threefry2x32` is the 20-round Threefry-2x32 hash with rotations
  (13, 15, 26, 6) and (17, 29, 16, 24);
- `split` and 32-bit `random_bits` follow the partitionable layout (the
  default of `jax_threefry_partitionable`): the counters are a uint64 iota
  over the output shape split into high and low words, `split` stacks the
  hash's two words, and 32-bit bits are their xor; 64-bit bits are
  `hi << 32 | lo`;
- `fold_in(key, d)` hashes the counter pair `[0, d]`;
- `uniform` fills the mantissa of a float in [1, 2) with the top bits,
  subtracts 1, scales, and clamps at `minval`; XLA fuses the scale
  `u * (maxval - minval) + minval` into one multiply-add with a single
  rounding, which float32 draws reproduce in float64 (the float32 product
  and the sum are exact there for the spans used here); float64 draws
  round twice, so they are exact only where the span is a power of two; `normal` (float32) is
  `sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))`; `bernoulli` is
  `uniform < p`; `randint` draws two bit arrays from a split key and
  reduces them with the span multiplier.

The float dtype defaults to float32 and the int dtype to int32, JAX's
defaults without `jax_enable_x64`. The numpy functions are uint32 arithmetic
on the host (torch's uint32 support is thin). `bits_on` and `uniform_on` are
the same hash in torch int64 ops (uint32 words held in int64, masked after
every add and shift) on a tensor device, bit for bit with 32-bit
`random_bits` and float32 `uniform`: the session's RANSAC draws are made
there. Their key is a host (2,) uint32 key, or the same two words as a
(2,) int64 tensor on the device (`key_on`): the captured step reads its
key from a device buffer that the host refills before each replay, so the
key is an operand of the graph and not a constant baked into it. Both
routes give the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2) under
    the key (k1, k2); all uint32, broadcast together."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x1 = np.asarray(x1, _U32) + ks[0]
        x2 = np.asarray(x2, _U32) + ks[1]
        for block in range(5):
            for r in _ROT[block % 2]:
                x1 = x1 + x2
                x2 = _rotl(x2, r) ^ x1
            x1 = x1 + ks[(block + 1) % 3]
            x2 = x2 + ks[(block + 2) % 3] + _U32(block + 1)
    return x1, x2


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key of `jax.random.PRNGKey(seed)`: the seed's 64 bits as
    (high, low) uint32 words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def _hash_iota(key: np.ndarray, shape):
    c1, c2 = _iota_2x32(tuple(shape))
    return threefry2x32(key[0], key[1], c1, c2)


def split(key: np.ndarray, num: int | tuple = 2) -> np.ndarray:
    """`jax.random.split`: (num, 2) uint32 keys (or (*num, 2))."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    b1, b2 = _hash_iota(np.asarray(key, _U32), shape)
    return np.stack([b1, b2], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in`: the key hashed with the counter pair [0, data]."""
    key = np.asarray(key, _U32)
    o1, o2 = threefry2x32(key[0], key[1], np.array([0], _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([o1[0], o2[0]], _U32)


def random_bits(key: np.ndarray, bit_width: int = 32, shape=()) -> np.ndarray:
    """`jax.random.bits`: unsigned integers of `bit_width` (8, 16, 32 or 64)."""
    b1, b2 = _hash_iota(np.asarray(key, _U32), tuple(shape))
    if bit_width == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16, 32 or 64, got {bit_width}")
    return (b1 ^ b2).astype(np.dtype(f"uint{bit_width}"))


def uniform(key: np.ndarray, shape=(), dtype=np.float32, minval=0.0, maxval=1.0) -> np.ndarray:
    """`jax.random.uniform` in [minval, maxval) for float32 or float64."""
    dtype = np.dtype(dtype)
    info = np.finfo(dtype)
    nbits, nmant = info.bits, info.nmant
    uint = np.dtype(f"uint{nbits}")
    bits = random_bits(key, nbits, shape)
    one = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint.type(nbits - nmant)) | one).view(dtype) - dtype.type(1.0)
    lo, hi = np.asarray(minval, dtype), np.asarray(maxval, dtype)
    if dtype == np.float32:  # XLA's fused multiply-add, one rounding
        scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(dtype)
    else:
        scaled = floats * (hi - lo) + lo
    return np.maximum(lo, scaled).astype(dtype)


# --- the same hash in torch int64 ops, on a device ----------------------------

_M32 = 0xFFFFFFFF


def _threefry2x32_on(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """`threefry2x32` on int64 tensors holding uint32 words; the key words
    are Python ints or 0-d int64 tensors on the counters' device."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x1 = (x1 + x2) & _M32
            x2 = (((x2 << r) & _M32) | (x2 >> (32 - r))) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & _M32
        x2 = (x2 + ((ks[(block + 2) % 3] + block + 1) & _M32)) & _M32
    return x1, x2


def key_on(key, device) -> torch.Tensor:
    """A host (2,) uint32 key as the (2,) int64 device tensor of its words."""
    return torch.as_tensor(np.asarray(key, _U32).astype(np.int64), device=device)


def _hash_iota_on(key, shape, device):
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    if torch.is_tensor(key):
        if key.shape != (2,) or key.dtype != torch.int64 or key.device != idx.device:
            raise ValueError(f"a device key is a (2,) int64 tensor on {idx.device}, got "
                             f"{tuple(key.shape)} {key.dtype} on {key.device}")
        k1, k2 = key.unbind(0)
    else:
        key = np.asarray(key, _U32)
        k1, k2 = int(key[0]), int(key[1])
    return _threefry2x32_on(k1, k2, idx >> 32, idx & _M32)


def bits_on(key, shape, device) -> torch.Tensor:
    """`random_bits(key, 32, shape)` made on `device`, as int64 holding the
    uint32 bits. `key` is a host (2,) uint32 key or its device words
    (`key_on`)."""
    b1, b2 = _hash_iota_on(key, tuple(shape), device)
    return b1 ^ b2


def uniform_on(key, shape, device, minval: float = 0.0,
               maxval: float = 1.0) -> torch.Tensor:
    """float32 `uniform(key, shape, minval=minval, maxval=maxval)` made on
    `device`, bit for bit; `key` as in `bits_on`."""
    mant = (bits_on(key, shape, device) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    span = torch.full((), maxval, dtype=torch.float32, device=device) - lo
    scaled = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's single-precision erf_inv (Giles' polynomial in w = -log1p(-x^2))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, the polynomial XLA evaluates."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = (np.where(lt, np.float32(a), np.float32(b)) + p * w).astype(np.float32)
        out = p * x
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), out).astype(np.float32)


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """`jax.random.normal` in float32, through XLA's erf_inv polynomial."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, np.float32, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv32(u)).astype(np.float32)


def bernoulli(key: np.ndarray, p: float = 0.5, shape=(), dtype=np.float32) -> np.ndarray:
    """`jax.random.bernoulli` (mode 'low'): uniform of p's dtype below p."""
    return uniform(key, shape, dtype) < np.asarray(p, dtype)


def randint(key: np.ndarray, shape, minval: int, maxval: int, dtype=np.int32) -> np.ndarray:
    """`jax.random.randint` in [minval, maxval) for int32 or int64 (scalar
    bounds inside the dtype's range)."""
    dtype = np.dtype(dtype)
    nbits = dtype.itemsize * 8
    uint = np.dtype(f"uint{nbits}")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, nbits, shape), random_bits(k2, nbits, shape)
    span = uint.type(max(int(maxval) - int(minval), 1))
    with np.errstate(over="ignore"):
        mult = uint.type(2 ** (nbits // 2)) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + (lower % span)) % span
        return (dtype.type(minval) + off.astype(dtype)).astype(dtype)
