"""Field specifications: moduli and precomputed Montgomery constants.

The port keeps the JAX package's Montgomery radix R = 2^(16*nlimbs), so
Montgomery forms are bit-identical between the two.  Elements live on the
device as little-endian 32-bit WORDS (nwords = nlimbs / 2): the memory image
of 16-bit little-endian limbs and of 32-bit words is the same, and 32-bit
words are what the CUDA multiply-add instructions consume.  In torch a word
array is an int32 tensor holding the uint32 bit pattern.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1


def int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    """Little-endian 16-bit limb decomposition as uint32."""
    if x < 0:
        raise ValueError("negative")
    out = np.zeros(nlimbs, dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    if x >> (LIMB_BITS * nlimbs):
        raise ValueError(f"{x} does not fit in {nlimbs} limbs")
    return out


def limbs_to_int(limbs) -> int:
    x = 0
    for i, v in enumerate(np.asarray(limbs).reshape(-1).tolist()):
        x += int(v) << (LIMB_BITS * i)
    return x


def int_to_words(x: int, nwords: int) -> np.ndarray:
    """Little-endian 32-bit word decomposition as uint32."""
    if x < 0:
        raise ValueError("negative")
    if x >> (WORD_BITS * nwords):
        raise ValueError(f"{x} does not fit in {nwords} words")
    return np.frombuffer(x.to_bytes(4 * nwords, "little"), dtype="<u4").copy()


def words_to_int(words) -> int:
    arr = np.asarray(words).reshape(-1).astype("<u4")
    return int.from_bytes(arr.tobytes(), "little")


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """All host-side constants for one prime field (computed from p alone)."""

    name: str
    p: int

    @functools.cached_property
    def bits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def nlimbs(self) -> int:
        return -(-self.bits // LIMB_BITS)

    @functools.cached_property
    def nwords(self) -> int:
        if self.nlimbs % 2:
            raise ValueError(f"{self.name}: odd limb count {self.nlimbs}")
        return self.nlimbs // 2

    @functools.cached_property
    def nbytes(self) -> int:
        return self.nlimbs * 2

    @functools.cached_property
    def r(self) -> int:
        """Montgomery radix R = 2^(16*nlimbs) = 2^(32*nwords)."""
        return 1 << (LIMB_BITS * self.nlimbs)

    @functools.cached_property
    def r_inv(self) -> int:
        return pow(self.r, -1, self.p)

    @functools.cached_property
    def r2(self) -> int:
        return (self.r * self.r) % self.p

    @functools.cached_property
    def n0inv(self) -> int:
        """-p^-1 mod 2^16 (limb-serial Montgomery reduction multiplier)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def n0inv32(self) -> int:
        """-p^-1 mod 2^32 (word-serial CIOS reduction multiplier)."""
        return (-pow(self.p, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)

    @functools.cached_property
    def nprime(self) -> int:
        """-p^-1 mod R (full-width Montgomery reduction multiplier)."""
        return (-pow(self.p, -1, self.r)) % self.r

    @functools.cached_property
    def nprime_limbs(self) -> np.ndarray:
        return int_to_limbs(self.nprime, self.nlimbs)

    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.p, self.nlimbs)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2, self.nlimbs)

    @functools.cached_property
    def one_mont_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r % self.p, self.nlimbs)

    @functools.cached_property
    def two_adicity(self) -> int:
        s, n = 0, self.p - 1
        while n % 2 == 0:
            s, n = s + 1, n // 2
        return s

    @functools.cached_property
    def two_adic_root(self) -> int:
        """An element of exact multiplicative order 2^two_adicity."""
        s = self.two_adicity
        odd = (self.p - 1) >> s
        x = 2
        while True:
            w = pow(x, odd, self.p)
            if s == 0:
                return 1
            if pow(w, 1 << (s - 1), self.p) != 1:
                return w
            x += 1

    def root_of_unity(self, logn: int) -> int:
        """Primitive 2^logn-th root of unity."""
        if logn > self.two_adicity:
            raise ValueError(
                f"{self.name}: 2-adicity {self.two_adicity} < requested {logn}"
            )
        return pow(self.two_adic_root, 1 << (self.two_adicity - logn), self.p)


# --- Named fields -----------------------------------------------------------
# Moduli match the three curves the reference supports
# (`src/ingo_msm/msm_cfg.rs:3-8`: BLS377, BLS381, BN254).

BN254_FQ = FieldSpec(
    "bn254_fq",
    21888242871839275222246405745257275088696311157297823662689037894645226208583,
)
BN254_FR = FieldSpec(
    "bn254_fr",
    21888242871839275222246405745257275088548364400416034343698204186575808495617,
)
BLS12_381_FQ = FieldSpec(
    "bls12_381_fq",
    4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
)
BLS12_381_FR = FieldSpec(
    "bls12_381_fr",
    52435875175126190479447740508185965837690552500527637822603658699938581184513,
)
BLS12_377_FQ = FieldSpec(
    "bls12_377_fq",
    258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
)
BLS12_377_FR = FieldSpec(
    "bls12_377_fr",
    8444461749428370424248824938781546531375899335154063827935233455917409239041,
)

FIELDS = {
    f.name: f
    for f in [
        BN254_FQ,
        BN254_FR,
        BLS12_381_FQ,
        BLS12_381_FR,
        BLS12_377_FQ,
        BLS12_377_FR,
    ]
}
