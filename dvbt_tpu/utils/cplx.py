"""Complex-arithmetic helpers.

Every device-path rotator/NCO in the package goes through `cis`, built from
real cos/sin rather than a complex `jnp.exp`, so the rotation is exactly
the same expression on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cis(ang: jnp.ndarray) -> jnp.ndarray:
    """exp(1j * ang) for real `ang`, built as cos + j*sin (complex64)."""
    ang = jnp.asarray(ang, jnp.float32)
    return jax.lax.complex(jnp.cos(ang), jnp.sin(ang)).astype(jnp.complex64)
