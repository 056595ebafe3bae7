"""Deterministic input generators.

Two generators, replicating the reference suite's determinism idiom:

1. ``Lcg`` — an exact port of the ``myrandom`` linear-congruential generator
   used by the atmosphere miniapp (reference:
   atmosphere/biharmonic_wk_kernel.F90:77-91): seed 11,
   ``state = mod(1301*state + 97, 131072)``, value ``state/131072``.
   This generator is integer-exact and therefore portable: our streams are
   bit-identical to the Fortran ones.  The fill order matches Fortran
   column-major array traversal (``fill_fortran``).

2. ``HostRng`` — a seeded, documented PCG64 generator used where the
   reference relies on the *non-portable* compiler intrinsic
   ``random_number`` (mpdata init seed=100: advect_scalar2D…F90:645-652;
   nested init, unseeded: nested.F90:59-107).  The reference only ever
   verifies variants against an in-process reference computed from the same
   stream, so the pattern — a single documented deterministic stream feeding
   both the reference and all variants — is what we replicate, not the
   compiler-specific bits.

The LCG is vectorized via affine-recurrence composition: for the step map
``f(x) = (a*x + c) mod m``, the k-step map is ``f_k(x) = (A_k*x + C_k) mod m``
with ``A_{j+k} = A_j*A_k`` and ``C_{j+k} = A_j*C_k + C_j`` (all mod m), so the
coefficient tables double in length per numpy op — O(n) work, O(log n)
Python iterations.
"""

from __future__ import annotations

import numpy as np

LCG_A = 1301
LCG_C = 97
LCG_M = 131072  # 1024 * 128 == 2**17
LCG_SEED = 11


class Lcg:
    """Exact port of the reference `myrandom` LCG (bit-identical stream)."""

    def __init__(self, seed: int = LCG_SEED):
        self.state = int(seed)
        # Coefficient tables: _ak[j] = A^{j+1} mod m, _ck[j] = C_{j+1} mod m,
        # grown on demand by affine composition.
        self._ak = np.array([LCG_A], dtype=np.int64)
        self._ck = np.array([LCG_C], dtype=np.int64)

    def reset(self, seed: int = LCG_SEED) -> None:
        self.state = int(seed)

    def _grow(self, n: int) -> None:
        while len(self._ak) < n:
            a_last = self._ak[-1]
            c_last = self._ck[-1]
            # f_{L+j} = f_j ∘ f_L: A = A_j*A_L, C = A_j*C_L + C_j  (mod m)
            self._ak = np.concatenate([self._ak, (self._ak * a_last) % LCG_M])
            self._ck = np.concatenate(
                [self._ck, (self._ak[: len(self._ck)] * c_last + self._ck) % LCG_M]
            )

    def draw(self, n: int) -> np.ndarray:
        """Draw n doubles in [0, 1), identical to n sequential Fortran calls."""
        self._grow(n)
        states = (self._ak[:n] * self.state + self._ck[:n]) % LCG_M
        self.state = int(states[-1])
        return states.astype(np.float64) / LCG_M

    def fill_fortran(self, shape: tuple[int, ...]) -> np.ndarray:
        """Fill an array of `shape` in Fortran column-major element order,
        as `call myrandom(product(shape(a)), a)` does, returning a C-ordered
        numpy array with the same logical indexing as the Fortran array."""
        n = int(np.prod(shape))
        flat = self.draw(n)
        return np.ascontiguousarray(flat.reshape(shape, order="F"))


class HostRng:
    """Documented deterministic generator for the miniapps whose reference
    init is compiler-dependent (mpdata, cke). PCG64 with an explicit seed."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def uniform(self, shape: tuple[int, ...] | int = ()) -> np.ndarray:
        return self.rng.random(shape, dtype=np.float64)
