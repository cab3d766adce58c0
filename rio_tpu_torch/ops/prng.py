"""Threefry-2x32 draws on tensors: the port's ``jax.random.normal(PRNGKey(seed), (dim,))``.

The JAX provider's hashed-identity features (``_hash_features``) seed one
``jax.random.PRNGKey`` per key with a 31-bit crc32 and draw ``dim``
standard normals from it. This module reproduces those draws for a batch
of seeds at once, on whatever device the seeds live on:

* :func:`threefry2x32` — the Threefry-2x32 block cipher (20 rounds, key
  injection every 4), as JAX's ``threefry2x32`` lowering computes it;
* :func:`random_bits` — ``jax.random.bits(key, (dim,))`` with
  ``jax_threefry_partitionable`` on (the JAX default since 0.5): word ``i``
  hashes the 64-bit counter ``i`` split as ``(hi, lo) = (0, i)`` and is the
  XOR of the two output words. A 32-bit seed is the key ``(0, seed)``;
* :func:`normal` — the bits to floats as ``jax.random.uniform`` maps them
  (23 mantissa bits under exponent 0, minus 1, scaled onto
  ``[nextafter(-1, 0), 1)``), then ``sqrt(2) * erfinv(u)``.

torch has little unsigned 32-bit arithmetic, so words live in ``int64``
tensors and every add and rotate is masked back to 32 bits. ``erfinv`` is
XLA's float32 polynomial (Giles' single-precision approximation), not
``torch.special.erfinv``: the two differ by up to ~2e-5 on the same bits.
Its square root is :func:`sqrt_rn`, correctly rounded as XLA's is.
"""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011), the
# single-precision branch pair that XLA's ErfInv lowers float32 to.
_ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x1, x2)`` under the key ``(k1, k2)``.

    All four are ``int64`` tensors holding values in ``[0, 2**32)`` and
    broadcast against each other; the two output words are the same.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK32
    x2 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x1, x2


def random_bits(seeds: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.random.bits(PRNGKey(seed), (dim,))`` for each 32-bit seed: (n, dim) int64."""
    k2 = seeds.to(torch.int64)[:, None]
    lo = torch.arange(dim, dtype=torch.int64, device=seeds.device)[None, :]
    b1, b2 = threefry2x32(torch.zeros_like(k2), k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of a float32 tensor.

    On the CPU ``torch.sqrt`` runs MKL's vector math: within an ulp, and in
    some processes about 3e-4 off on its first multithreaded call. Two
    Newton steps in float64 from its result reach double precision, and
    rounding that to float32 gives the correctly rounded root, as XLA's
    and CUDA's float32 sqrt do. Zero, infinite and negative inputs take
    ``torch.sqrt`` as it is.
    """
    xd = x.double()
    y = xd.sqrt()
    for _ in range(2):
        y = 0.5 * (y + xd / y)
    regular = torch.isfinite(xd) & (xd > 0)
    return torch.where(regular, y, xd.sqrt()).float()


def erfinv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv``: Giles' polynomial in ``w = -log1p(-u*u)``.

    ``-u*u`` is rounded to float32 as XLA rounds it; its ``log1p`` is taken
    in float64 and rounded once, so the CPU and the card get the same
    ``w`` (within an ulp of XLA's), and the float32 polynomial after it is
    the same elementwise arithmetic on both.
    """
    w = -torch.log1p((-u * u).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt_rn(w) - 3.0)
    p = torch.where(small, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for lt5, ge5 in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = torch.where(small, lt5, ge5) + p * w
    return torch.where(u.abs() == 1.0, u * torch.finfo(torch.float32).max, p * u)


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) to ``jax.random.normal`` float32 draws."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)  # < 2**31: fits
    floats = mant.view(torch.float32) - 1.0
    # [lo, 1) with lo = nextafter(-1, 0) in float32; 1 - lo rounds to 2.0.
    # A fill, not a copy from the host: the draw may be captured in a CUDA graph.
    lo = torch.full((), -1.0 + 2.0**-24, dtype=torch.float32, device=bits.device)
    u = torch.maximum(floats * 2.0 + lo, lo)
    return erfinv(u) * math.sqrt(2.0)


def normal(seeds: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.random.normal(PRNGKey(seed), (dim,))`` for each 32-bit seed: (n, dim) float32."""
    return bits_to_normal(random_bits(seeds, dim))
