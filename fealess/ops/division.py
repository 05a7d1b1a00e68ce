"""Correctly rounded f32 division, the same on every platform.

XLA's f32 division on a GPU is not correctly rounded (about 2 in 3
quotients ``x * 100 / 504`` differ from IEEE division by an ulp), so a
quotient that feeds a comparison, a ``trunc`` or a sort — the detector's
score conversions, the tracker's scale updates — would differ between the
GPU and the CPU.  :func:`div_exact` divides the 24-bit mantissas by integer
long division and rounds to nearest even, so it equals IEEE division
bit for bit wherever the quotient is a normal f32 or zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_MANT = 0x7FFFFF
_HIDDEN = 0x800000


def div_exact(n, d) -> jax.Array:
    """IEEE round-to-nearest-even f32 ``n / d``, elementwise.

    Valid for finite normal operands (or ``n == 0``) whose quotient is a
    normal f32; other inputs give unspecified values.
    """
    n = jnp.asarray(n, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    bn = jax.lax.bitcast_convert_type(jnp.abs(n), jnp.int32)
    bd = jax.lax.bitcast_convert_type(jnp.abs(d), jnp.int32)
    mn = (bn & _MANT) | _HIDDEN
    md = (bd & _MANT) | _HIDDEN
    # Normalise so the quotient of the mantissas lies in [1, 2).
    below = mn < md
    r = jnp.where(below, mn << 1, mn)
    e = (bn >> 23) - (bd >> 23) + 127 - below.astype(jnp.int32)
    # 24 quotient bits plus one guard bit; r < 2 * md < 2**25 throughout.
    q = jnp.zeros_like(r)
    for _ in range(25):
        bit = r >= md
        q = (q << 1) | bit.astype(jnp.int32)
        r = jnp.where(bit, r - md, r) << 1
    mant = q >> 1
    up = ((q & 1) == 1) & ((r != 0) | ((mant & 1) == 1))
    mant = mant + up.astype(jnp.int32)
    carry = mant >> 24                      # rounding overflowed to 2.0
    mant = mant >> carry
    e = e + carry
    out = jax.lax.bitcast_convert_type((e << 23) | (mant & _MANT),
                                       jnp.float32)
    out = jnp.where(jnp.signbit(n) != jnp.signbit(d), -out, out)
    return jnp.where(n == 0, jnp.zeros_like(out), out)
