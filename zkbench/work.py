"""The yardstick's work counts and the card's limits, frozen here so that a
change to the program cannot move them.

Each count is (bytes, IMADs): the bytes the algorithm must move (inputs
read once, outputs written once) and the 32-bit multiply-adds of the
Montgomery products it must make, whatever implements it.  A roofline
share is `bound_s(work) / device seconds`: the least time the card could
take over the time it took.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    """One card's limits."""

    hbm_bytes_per_s: float
    imad_per_clk_per_sm: int
    sms: int
    max_sm_clock_mhz: float

    @property
    def imad_per_s(self) -> float:
        return self.sms * self.imad_per_clk_per_sm * self.max_sm_clock_mhz * 1e6


# Key: torch.cuda.get_device_name().  The H100 SXM data sheet's 3.35 TB/s
# and 132 SMs, compute capability 9.0's 64 IMADs per clock per SM, and the
# 1980 MHz max SM clock that nvidia-smi reads on the card.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(hbm_bytes_per_s=3.35e12, imad_per_clk_per_sm=64,
                                   sms=132, max_sm_clock_mhz=1980.0),
}


def peaks_for(kind: str) -> Peaks:
    """The limits of the card named `kind`; another card raises, since any
    other row would state its shares against wrong limits."""
    if kind not in PEAKS:
        raise ValueError(f"no peaks for {kind!r} (known: {sorted(PEAKS)})")
    return PEAKS[kind]


def product_imads(W: int) -> int:
    """One W-word Montgomery product: 2W^2 full 32x32->64 products (2
    IMADs each) and W low products."""
    return 4 * W * W + W


def poseidon_imads(t: int, r_f: int, r_p: int, convert_in: int, W: int) -> int:
    """One Poseidon permutation of width t on the sparse schedule: 3 full
    products per S-box (r_f t + r_p of them) and t more with convert_in; a
    full round's mix is t^2 unreduced products (2W^2 each) and t row REDCs
    (2W^2 + W); a sparse partial round's mix t unreduced products, one REDC
    and t - 1 full products."""
    full, unreduced, redc = product_imads(W), 2 * W * W, 2 * W * W + W
    n = (3 * (r_f * t + r_p) + t * convert_in) * full
    n += r_f * t * (t * unreduced + redc)
    return n + r_p * (t * unreduced + redc + (t - 1) * full)


def msm_work(n: int, window_bits: int, base_words: int, scalar_bits: int,
             scalar_limbs: int) -> tuple:
    """An n-point MSM by the bucket method with c-bit windows.  Bytes: one
    read of the resident operands, n (2W 4 + Ls 2).  Products: per window
    every point added into one bucket (a mixed add, 13 products), the
    running-sum bucket reduction (2 (2^c - 1) complete adds of 14), and
    the Horner fold of the windows ((nwin - 1)(c + 1) group ops of 14)."""
    c, W = window_bits, base_words
    nwin = -(-scalar_bits // c)
    products = nwin * (13 * n + 14 * 2 * ((1 << c) - 1)) + 14 * (nwin - 1) * (c + 1)
    return n * (2 * W * 4 + scalar_limbs * 2), products * product_imads(W)


def ntt_work(logn: int, W: int) -> tuple:
    """A 2^logn-point NTT: the buffer read once and written once, and
    (n/2) log2 n twiddle products less the n - 1 whose twiddle is 1."""
    n = 1 << logn
    products = (n // 2) * logn - (n - 1)
    return 2 * n * W * 4, products * product_imads(W)


def tree_work(height: int, arity: int, columns: int, W: int, leaf: dict,
              node: dict) -> tuple:
    """One TreeC build: leaves of `columns` elements hashed by the leaf
    permutation (inputs brought into Montgomery form), one node
    permutation per node above them, and one product per record to bring
    each hash out of Montgomery form.  Bytes: the columns read once and
    the leaf hashes written once.  `leaf` and `node` give t, r_f, r_p."""
    nleaves = arity ** (height - 1)
    nodes = (nleaves - 1) // (arity - 1)
    imads = (nleaves * poseidon_imads(leaf["t"], leaf["r_f"], leaf["r_p"], 1, W)
             + nodes * poseidon_imads(node["t"], node["r_f"], node["r_p"], 0, W)
             + (nleaves + nodes) * product_imads(W))
    return nleaves * (columns + 1) * W * 4, imads


def bound_s(work: tuple, peaks: Peaks) -> tuple:
    """(least seconds, "bytes" or "operations") of `work`: the larger of the
    bytes over the memory bandwidth and the IMADs over the IMAD rate."""
    nbytes, imads = work
    t_ops, t_bytes = imads / peaks.imad_per_s, nbytes / peaks.hbm_bytes_per_s
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
