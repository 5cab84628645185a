"""Counter-based random numbers with the JAX package's key semantics: the
``threefry2x32`` cipher and the ``jax.random`` functions the environments
and the trainers draw from (``PRNGKey``, ``split``, ``fold_in``, ``uniform``,
``normal``, ``exponential``, ``randint``, ``permutation``), with
``jax_threefry_partitionable`` on.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words, the
counterpart of a raw ``uint32[2]`` JAX key; a batch of keys ``(B, 2)`` is the
counterpart of ``jax.random.split(key, B)``.  Every function works
elementwise over the leading axes of its keys: ``normal(keys, n)`` draws
``n`` values per key, the ``(..., n)`` result equal to ``vmap(lambda k:
jax.random.normal(k, (n,)))(keys)``; a shape tuple in place of ``n``
(``normal(key, (B, A))``) numbers the elements in row-major order, as
``jax.random.normal(key, (B, A))`` does.  The words live in int64 so that no
operation overflows or needs a logical shift on a signed 32-bit type.

Exactness against ``jax.random``: ``split`` and ``fold_in`` agree bit for
bit (pure integer arithmetic), and so do the random bits under ``uniform``,
``randint`` and ``permutation``.
``uniform`` is exact too (a bit cast, then one fused multiply-add, as
XLA computes it on the CPU); ``normal`` applies ``erfinv``, whose float32 and
float64 implementations differ by a few ulps between XLA and PyTorch.
On the CPU, ``erfinv`` runs in fixed slices on the calling thread, so a
draw does not depend on the number of intra-op threads.

Each call is plain PyTorch on the device of its keys, one eager operation
after another (about 165 for one cipher evaluation); no ``torch.Generator``
is involved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: the key-schedule parity constant of Threefry
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), ``jax._src.prng``'s
    ``_threefry2x32_lowering``: key words ``(k0, k1)``, counter words ``(x0,
    x1)``, all int64 tensors (or Python ints) holding uint32 values and
    broadcast together.  Returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _words(keys):
    if not isinstance(keys, torch.Tensor) or keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"a key is an int64 tensor of shape (..., 2), got {getattr(keys, 'shape', type(keys))}")
    return keys[..., 0], keys[..., 1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed (``jax.random.PRNGKey``): the seed's 64
    bits as two uint32 words, high word first.  ``device`` defaults to CUDA
    and raises without a GPU, as the port's entry points do."""
    from exciting_environments_torch.core.env import resolve_device

    v = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([(v >> 32) & MASK32, v & MASK32], dtype=torch.int64, device=resolve_device(device))


def _cipher_at(keys, counters_lo):
    """The cipher of every key at the counters ``(0, lo)``, ``lo`` an int64
    tensor broadcast against the keys' leading axes.  Returns the two words."""
    k0, k1 = _words(keys)
    return threefry2x32(k0, k1, torch.zeros_like(counters_lo), counters_lo)


def _shape(n) -> tuple:
    return (int(n),) if isinstance(n, (int, np.integer)) else tuple(int(d) for d in n)


def _cipher_shaped(keys, shape: tuple):
    """The cipher of every key at the row-major counters of ``shape``
    (``iota_2x32_shape``; fewer than 2**32 elements): two words of shape
    ``keys.shape[:-1] + shape``."""
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device).reshape(shape)
    return _cipher_at(keys.reshape(keys.shape[:-1] + (1,) * len(shape) + (2,)), count)


def split(keys, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key into ``num`` keys: ``(..., num, 2)``."""
    count = torch.arange(num, dtype=torch.int64, device=keys.device)
    b0, b1 = _cipher_at(keys[..., None, :], count)
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys, data) -> torch.Tensor:
    """``jax.random.fold_in``: the cipher of each key at ``(0, data)``.
    ``data`` is an int or an int tensor broadcast against the keys' leading
    axes (taken modulo 2**32, as JAX casts it to uint32)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK32
    b0, b1 = _cipher_at(keys, data)
    return torch.stack([b0, b1], dim=-1)


def _unit_floats(keys, n, dtype: torch.dtype):
    """``n`` floats (or a shape of them) in ``[0, 1)`` per key from the
    partitionable random bits of ``jax.random.uniform``: mantissa bits under
    the exponent of 1.0, minus 1.  Shape ``keys.shape[:-1] + (n,)``."""
    b0, b1 = _cipher_shaped(keys, _shape(n))
    if dtype == torch.float32:
        bits = ((b0 ^ b1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    # float64: the top 52 of the 64 bits (b0 << 32 | b1) under the exponent of 1.0
    bits = (b0 << 20) | (b1 >> 12) | 0x3FF0000000000000
    return bits.view(torch.float64) - 1.0


def _np(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"draws are float32 or float64, got {dtype}")
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


#: Veltkamp's splitting constant for float64, ``2**27 + 1``
_SPLIT = 134217729.0


def _split(x):
    """``x = hi + lo`` with ``hi`` holding the upper 26 significant bits."""
    c = _SPLIT * x
    hi = c - (c - x)
    return hi, x - hi


def fma(x, a: float, b: float):
    """``x * a + b`` rounded once, as a fused multiply-add, for a tensor ``x``
    and Python numbers ``a``, ``b`` representable in its dtype.  float32:
    the exact product in float64, the sum rounded there and then to float32
    (a double rounding, which can differ where the float64 sum lands on a
    float32 tie).  float64: the product's exact error (Dekker's
    two-product) and the sum's (Knuth's two-sum), added before the last
    rounding (which can differ where that addition rounds).  Both match
    XLA's fused result in every draw of tests/test_torch_random.py's check
    (640,000 over four spans in both widths)."""
    if x.dtype == torch.float32:
        return (x.double() * a + b).float()
    p = x * a
    xh, xl = _split(x)
    ah, al = _split(torch.tensor(a, dtype=torch.float64))
    ah, al = float(ah), float(al)
    e = ((xh * ah - p) + xh * al + xl * ah) + xl * al
    s = p + b
    v = s - p
    t = (p - (s - v)) + (b - v)
    return s + (t + e)


def uniform(keys, n, dtype: torch.dtype, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)`` per key (``n``
    an int or a shape):
    ``max(minval, f * (maxval - minval) + minval)`` with the bounds and their
    difference rounded to ``dtype`` first.  XLA contracts the multiply and
    the add into one fused multiply-add on the CPU; so does this function
    (:func:`fma`) where the product can round, that is where the span is no
    power of two."""
    nd = _np(dtype)
    lo, hi = nd(minval), nd(maxval)
    span = float(hi - lo)
    f = _unit_floats(keys, n, dtype)
    exact = span == 0.0 or math.frexp(span)[0] == 0.5
    return torch.clamp_min(f * span + float(lo) if exact else fma(f, span, float(lo)), float(lo))


#: elements per ``erfinv`` call on the CPU: below the grain at which
#: PyTorch's CPU kernel splits a call across its intra-op threads, whose
#: float64 results have been seen to differ from the calling thread's by
#: ~1e-8 relative
CPU_ERFINV_SLICE = 1024


def _erfinv(u: torch.Tensor) -> torch.Tensor:
    """``torch.special.erfinv``; on the CPU in slices of
    :data:`CPU_ERFINV_SLICE` elements, each on the calling thread."""
    if u.device.type != "cpu" or u.numel() <= CPU_ERFINV_SLICE:
        return torch.special.erfinv(u)
    flat = u.contiguous().view(-1)
    return torch.cat([torch.special.erfinv(s) for s in flat.split(CPU_ERFINV_SLICE)]).view(u.shape)


def normal(keys, n, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.normal(key, (n,), dtype)`` per key (``n`` an int or a
    shape): ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform on ``(nextafter(-1, 0), 1)``."""
    nd = _np(dtype)
    lo = np.nextafter(nd(-1.0), nd(0.0), dtype=nd)
    u = uniform(keys, n, dtype, float(lo), 1.0)
    return _erfinv(u) * float(nd(math.sqrt(2)))


def exponential(keys, n, dtype: torch.dtype) -> torch.Tensor:
    """``jax.random.exponential(key, (n,), dtype)`` per key: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(keys, n, dtype))


def random_bits(keys, n) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` per key: the two words of the
    cipher xor-ed, uint32 values in int64.  ``n`` an int or a shape."""
    b0, b1 = _cipher_shaped(keys, _shape(n))
    return b0 ^ b1


#: the largest span ``randint`` takes: every product of its reduction then
#: stays below 2**62, exact in int64
MAX_RANDINT_SPAN = 2**31


def randint(keys, n, minval: int, maxval: int, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype)`` per key
    (``n`` an int or a shape): two draws of random bits, the higher one
    folded by ``2**nbits % span`` and the lower one added, modulo the span
    (biased where the span is no power of two, as in JAX).  ``dtype`` int64
    (the JAX default under ``jax_enable_x64``: 64-bit draws) or int32 (32-bit
    draws).  Spans up to :data:`MAX_RANDINT_SPAN`; ``maxval <= minval``
    returns ``minval``."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"randint draws int32 or int64, got {dtype}")
    minval, maxval = int(minval), int(maxval)
    span = maxval - minval if maxval > minval else 1
    if span > MAX_RANDINT_SPAN:
        raise ValueError(f"randint takes spans up to 2**31, got {span}")
    shape = _shape(n)
    pair = split(keys)
    hi0, hi1 = _cipher_shaped(pair[..., 0, :], shape)
    lo0, lo1 = _cipher_shaped(pair[..., 1, :], shape)
    if dtype == torch.int64:
        # the 64-bit words (w0 << 32 | w1) modulo the span, by parts
        word = 2**32 % span
        higher = ((hi0 % span) * word + hi1 % span) % span
        lower = ((lo0 % span) * word + lo1 % span) % span
        mult = (word * word) % span
        offset = (higher * mult + lower) % span
    else:
        # uint32 arithmetic: every product and sum wraps at 2**32
        mult = ((2**16 % span) ** 2 & MASK32) % span
        higher, lower = (hi0 ^ hi1) % span, (lo0 ^ lo1) % span
        offset = ((((higher * mult) & MASK32) + lower) & MASK32) % span
    return (offset + minval).to(dtype)


def permutation(keys, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` per key: ``ceil(3 ln n / ln(2**32 -
    1))`` rounds, each splitting the key, drawing 32 random bits per element
    and sorting the running order by them, stably (ties keep their order, as
    ``lax.sort_key_val`` does).  int64, shape ``keys.shape[:-1] + (n,)``."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(keys.shape[:-1] + (n,))
    for _ in range(rounds):
        pair = split(keys)
        keys = pair[..., 0, :]
        order = torch.sort(random_bits(pair[..., 1, :], n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def choice(keys, values, n, p=None) -> torch.Tensor:
    """``jax.random.choice(key, values, shape, replace=True, p=p)`` per key
    (``n`` an int or a shape).

    Without ``p`` the indices are :func:`randint` draws over ``[0,
    len(values))``; with ``p`` each sample is ``searchsorted(cumsum(p),
    cumsum(p)[-1] * (1 - u), side="left")`` for one :func:`uniform` draw
    ``u``.  ``values`` is a 1-D tensor (its device is the keys'); its dtype
    stands for JAX's default dtypes: float64 values draw the 64-bit indices
    of ``jax_enable_x64`` and ``p`` in float64, float32 values the 32-bit
    indices and float32 ``p``.  The cumulative sum runs left to right in that
    dtype, on the host (``p`` is a short host sequence)."""
    values = torch.as_tensor(values, device=keys.device)
    if values.ndim != 1 or values.numel() == 0:
        raise ValueError(f"choice takes a non-empty 1-D tensor of values, got shape {tuple(values.shape)}")
    wide = values.dtype in (torch.float64, torch.int64)
    n_inputs = values.numel()
    if p is None:
        index = randint(keys, n, 0, n_inputs, torch.int64 if wide else torch.int32).long()
    else:
        fdtype = torch.float64 if wide else torch.float32
        p_np = np.asarray(p.detach().cpu() if isinstance(p, torch.Tensor) else p, dtype=_np(fdtype))
        if p_np.shape != (n_inputs,):
            raise ValueError(f"p must be a 1-D vector of the values' length {n_inputs}, got shape {p_np.shape}")
        p_cuml = torch.as_tensor(np.cumsum(p_np), device=keys.device)
        r = p_cuml[-1] * (1 - uniform(keys, n, fdtype))
        index = torch.searchsorted(p_cuml, r.contiguous())
    return values[index]
