"""Poseidon in plain Python ints: the instance's constants generated here
from its parameters, the dense permutation, and the sponge TreeC uses.

The constants follow the Poseidon paper's reference generator
(generate_parameters_grain.sage: a self-shrinking Grain LFSR seeded with
the field, S-box, width and round counts) and a Cauchy MDS matrix
m[i][j] = 1 / (i + t + j); a frozen copy of the program's plain
generator, so the reference never reads the program's tables.
"""
from __future__ import annotations

import dataclasses


def _grain_bits(field_bits: int, t: int, r_f: int, r_p: int):
    def bits_of(value, width):
        return [(value >> (width - 1 - i)) & 1 for i in range(width)]

    state = (bits_of(1, 2) + bits_of(0, 4) + bits_of(field_bits, 12) + bits_of(t, 12)
             + bits_of(r_f, 10) + bits_of(r_p, 10) + [1] * 30)

    def update():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        update()
    while True:
        b1, b2 = update(), update()
        if b1:
            yield b2


@dataclasses.dataclass(frozen=True)
class Instance:
    p: int
    t: int
    alpha: int
    r_f: int
    r_p: int
    rc: tuple          # ((r_f + r_p) t,) round constants
    mds: tuple         # t x t


def instance(p: int, t: int, r_f: int, r_p: int, alpha: int = 5) -> Instance:
    """The instance of width t over F_p with r_f full and r_p partial rounds."""
    bits = p.bit_length()
    gen = _grain_bits(bits, t, r_f, r_p)
    rc = []
    while len(rc) < (r_f + r_p) * t:
        v = 0
        for _ in range(bits):
            v = (v << 1) | next(gen)
        if v < p:
            rc.append(v)
    mds = tuple(tuple(pow(i + t + j, -1, p) for j in range(t)) for i in range(t))
    return Instance(p, t, alpha, r_f, r_p, tuple(rc), mds)


def permute(inst: Instance, state: list) -> list:
    """The dense permutation: per round, add the round constants, apply
    x^alpha to every element (full rounds, r_f / 2 before and after) or to
    the first (partial rounds), then multiply by the MDS matrix."""
    p, t = inst.p, inst.t
    s = [x % p for x in state]
    half = inst.r_f // 2
    for r in range(inst.r_f + inst.r_p):
        s = [(x + inst.rc[r * t + i]) % p for i, x in enumerate(s)]
        if r < half or r >= half + inst.r_p:
            s = [pow(x, inst.alpha, p) for x in s]
        else:
            s[0] = pow(s[0], inst.alpha, p)
        s = [sum(m * x for m, x in zip(row, s)) % p for row in inst.mds]
    return s


def hash_(inst: Instance, inputs: list, domain_tag: int = 0) -> int:
    """The sponge of one TreeC leaf or node: state [tag, inputs...], the
    hash is state[1] after one permutation."""
    if len(inputs) != inst.t - 1:
        raise ValueError(f"want {inst.t - 1} inputs, got {len(inputs)}")
    return permute(inst, [domain_tag, *inputs])[1]
