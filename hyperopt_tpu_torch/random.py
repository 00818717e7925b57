"""Threefry-2x32 counter-based random numbers, bitwise equal to ``jax.random``.

The port's every random draw goes through this module, so that one seed
gives the same bits here as in the JAX reference and whole ``fmin``
streams can be held against each other.  It reproduces JAX's default
``threefry2x32`` implementation under ``jax_threefry_partitionable=True``
(the default since JAX 0.5):

* a key is the pair of uint32 words ``(k1, k2)``; ``key(seed)`` is
  ``(0, seed & 0xffffffff)``, as JAX builds it outside x64 mode (its
  default, and the reference's);
* ``split(key, n)`` hashes the counters ``(0, i)``, ``i < n``, and the
  two output words of counter ``i`` are the ``i``-th new key;
* ``fold_in(key, data)`` hashes the one counter ``(0, data mod 2**32)``
  (``threefry_seed`` of a 32-bit word) into a new key;
* ``n`` random 32-bit words hash the counters ``(i >> 32, i & 0xffffffff)``
  of a row-major iota over the requested shape and keep ``bits1 ^ bits2``;
* ``randint`` draws two words per value from ``split(key)`` and folds
  them into the span as ``jax.random.randint`` does (uint32 wraparound,
  ``(2**16 mod span)**2 mod span`` in uint32 as the high word's weight);
* ``uniform`` sets the 23 high bits as the mantissa of a float in
  [1, 2) and subtracts one; ``normal`` is ``sqrt(2) * erfinv(u)``;
  ``categorical`` is the low-range Gumbel-max trick.

Keys are int64 tensors of shape ``[..., 2]`` holding the two words; every
function is vectorized over the leading batch of keys.  The words live in
int64 masked to 32 bits, so the bits are the same on the CPU and on CUDA
(PyTorch has no unsigned 32-bit arithmetic).  The floats built from the
bits are exact for ``uniform``.  ``normal`` evaluates XLA's own erfinv,
log1p and log polynomials with XLA's multiply-add rounding, and stays
within 2 ulp of JAX's (almost always bitwise).  ``categorical`` takes
PyTorch's ``log``, whose last bit may differ; only the argmax is drawn.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "split", "fold_in", "random_bits", "randint", "uniform", "normal",
           "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all int64 in [0, 2**32), broadcast
    together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    y = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & _MASK
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        y = (y + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, y


def key(seed, device="cpu"):
    """A key ``[2]`` from an integer seed (``jax.random.key(seed)`` with
    x64 off: the seed is taken modulo 2**32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def _words(key, ndim):
    """The key words shaped to broadcast against ``ndim`` trailing dims."""
    view = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def _iota_2x32(shape, device):
    """(hi, lo) words of a row-major uint64 iota over ``shape``."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return i >> 32, i & _MASK


def split(key, num=2):
    """``[..., 2]`` keys -> ``[..., num, 2]`` new keys (``jax.random.split``)."""
    k1, k2 = _words(key, 1)
    hi, lo = _iota_2x32((int(num),), key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data):
    """``[..., 2]`` keys with ``data`` folded in (``jax.random.fold_in``
    with x64 off): ``data`` is an int or an integer tensor that broadcasts
    against the key batch (a device counter folds in without a host
    read), taken modulo 2**32."""
    k1, k2 = _words(key, 0)
    b1, b2 = threefry2x32(k1, k2, 0, data & _MASK)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


# float32 constants of the draws, one tensor per (value, device): made
# at the first call, so that a step captured into a CUDA graph after a
# warm-up copies nothing from the host
_CONSTS = {}


def _const(value, device):
    t = _CONSTS.get((value, device))
    if t is None:
        t = _CONSTS[(value, device)] = torch.tensor(value, dtype=torch.float32, device=device)
    return t


def random_bits(key, shape):
    """32 random bits per element, int64 ``[..., *shape]`` in [0, 2**32)."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _iota_2x32(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def randint(key, shape, minval, maxval):
    """int64 integers in ``[minval, maxval)``, ``[..., *shape]``
    (``jax.random.randint`` with its default int32, bit for bit).

    ``minval``/``maxval`` are ints in the int32 range; ``maxval <=
    minval`` gives ``minval``.  Plain int64 operations, so a draw
    captures into a CUDA graph."""
    shape = tuple(int(s) for s in shape)
    # the two words of each value from split(key)'s two keys, in one hash
    higher, lower = random_bits(split(key), shape).unbind(-len(shape) - 1)
    lo = int(minval)
    span = max(int(maxval) - lo, 1)  # as uint32: at most 2**32 - 1
    multiplier = ((2**16 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * multiplier + lower % span) & _MASK) % span
    out = (lo + offset) & _MASK  # int32 wraparound
    return torch.where(out > 2**31 - 1, out - 2**32, out)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """float32 uniforms in [minval, maxval), ``[..., *shape]``
    (``jax.random.uniform``, bit for bit)."""
    bits = random_bits(key, shape)
    # JAX views (bits >> 9) | 0x3F800000 as a float in [1, 2) and subtracts
    # 1: that is (bits >> 9) * 2**-23 exactly, which needs no dtype view
    # (a view that torch.func.vmap cannot batch in every release)
    floats = (bits >> 9).to(torch.float32) * 2.0**-23
    lo = _const(float(minval), key.device)
    hi = _const(float(maxval), key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' single-precision erfinv ("Approximating the erfinv function",
# 2010): the polynomial XLA lowers ``erf_inv`` to for float32, for
# w = -log1p(-x^2) < 5 (on w - 2.5) and otherwise (on sqrt(w) - 3).
_ERFINV_W_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_W_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _f32(values):
    return tuple(float(np.float32(v)) for v in values)


# Cephes' logf, as XLA's CPU backend evaluates float32 log: the mantissa
# polynomial in three multiply-add chains, the exponent added back in two
# parts (q1, q2)
_LOG_P = _f32((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
               1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
               3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32((-2.12194440e-4, 0.693359375))
_SQRT_HALF = float(np.float32(0.707106781186547524))
# XLA's float32 log1p below |x| < sqrt(2) - 1: Cephes' rational
# approximation (numerator and denominator, highest degree first)
_LOG1P_NUM = _f32((4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                   6.5787325942061044846969e0, 2.9911919328553073277375e1,
                   6.0949667980987787057556e1, 5.7112963590585538103336e1,
                   2.0039553499201281259648e1))
_LOG1P_DEN = _f32((1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                   2.2176239823732856465394e2, 3.0909872225312059774938e2,
                   2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as XLA's contracted
    multiply-adds round (the float64 product of two float32s is exact)."""
    return (a.double() * b + c).float()


def _horner(x, coeffs):
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log(x):
    """float32 log of positive normal ``x`` as XLA evaluates it (within
    1 ulp, almost always bitwise; PyTorch's log differs in ~7% of last
    bits)."""
    # x = m * 2**e with m in [0.5, 1): for a positive normal x, the bit
    # split of the exponent field, without a dtype view (see uniform)
    m, e = torch.frexp(x)
    small = m < _SQRT_HALF  # shift to [sqrt(1/2), sqrt(2)) and by -1
    m = (m - 1.0) + torch.where(small, m, 0.0)
    e = (e - small.to(torch.int32)).to(torch.float32)
    m2 = m * m
    m3 = m2 * m
    y = _fma(_fma(torch.full_like(m, _LOG_P[0]), m, _LOG_P[1]), m, _LOG_P[2])
    y1 = _fma(_fma(torch.full_like(m, _LOG_P[3]), m, _LOG_P[4]), m, _LOG_P[5])
    y2 = _fma(_fma(torch.full_like(m, _LOG_P[6]), m, _LOG_P[7]), m, _LOG_P[8])
    y = _fma(_fma(y, m3, y1), m3, y2) * m3
    y = _fma(e, _LOG_Q1, y)
    return _fma(e, _LOG_Q2, (m - m2 * 0.5) + y)


def _log1p(x):
    """float32 log1p of ``x`` in (-1, 0] as XLA evaluates it."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)))
    return torch.where(torch.abs(x) < 0.41421356237309504880, small, _log(x + 1.0))


def _f32(v, like):
    """A Python float as a float32 0-dim tensor on ``like``'s device: a
    ``torch.where`` of two Python floats takes the default dtype, which
    a caller may have set to float64."""
    return torch.scalar_tensor(v, dtype=torch.float32, device=like.device)


def _erfinv(x):
    """float32 erfinv of ``x`` in (-1, 1) by XLA's polynomial, with XLA's
    log1p and its multiply-add contraction, so normals stay within 2 ulp
    of ``jax.random.normal`` (``torch.special.erfinv`` is more exact, but
    lies up to ~90 ulp from XLA's)."""
    w = -_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_W_LT5[0], lt), _f32(_ERFINV_W_GE5[0], lt))
    for a, b in zip(_ERFINV_W_LT5[1:], _ERFINV_W_GE5[1:]):
        p = _fma(p, w, torch.where(lt, _f32(a, lt), _f32(b, lt)))
    return p * x


def normal(key, shape):
    """float32 standard normals ``[..., *shape]`` (``jax.random.normal``:
    ``sqrt(2) * erfinv(u)`` on the same uniforms)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _erfinv(u) * _SQRT2


def categorical(key, logits, shape):
    """Category draws ``[..., *shape]`` from ``logits [..., K]`` broadcast
    against ``shape`` (``jax.random.categorical(key, logits, axis=-1,
    shape=shape)``): argmax of logits plus low-range Gumbel noise drawn
    over ``(*shape, K)``."""
    shape = tuple(int(s) for s in shape)
    k = logits.shape[-1]
    u = uniform(key, shape + (k,), _F32_TINY, 1.0)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)
