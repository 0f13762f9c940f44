"""The port of experiments/: the five probe scripts whose pallas_calls
measure the field product's parts on the TPU, as kernels for the H100.

One module per script, so that a reader finds the counterpart by name:

  pallas_mul        E1  experiments/pallas_mul.py:146 PallasMont.mul: the
                        Montgomery product with its REDC on the int8
                        tensor cores (csrc/mont_tc.cu)
  redc_probe        E2  experiments/redc_probe.py:66: the product's parts,
                        chained (csrc/probe_chain.cu, mont_tc.cu)
  vpu_mul_probe     E3  experiments/vpu_mul_probe.py:81: the card's three
                        multiply forms, the product, the IMAD and the FFMA
                        convolutions, chained
  mul_kernel_bench  E4  experiments/mul_kernel_bench.py:83: four bodies in
                        S = 4 independent streams per thread
  kernel_variants   E5  experiments/kernel_variants.py:46: one product, 11
                        independent, 11 chained, 15 adds and subs, the
                        mixed-add body on K2's team of six

`chain` holds the wrappers, their plain versions and the slope timer;
`python -m blaze_tpu_torch.experiments` runs all five on the card.
Nothing runs at import.  Entry points run on the card unless the caller
passes device="cpu" (the plain versions).
"""

# Each probe's run() keyword arguments at the cut size chip_smoke.py runs
# (2^16 lanes, chains of at most 9 steps, every lane held against the plain
# version); the defaults of run() are the full sizes.
CUT = {
    "E1": {"one_lanes": 1 << 16, "chain_lanes": 1 << 16, "check_lanes": None},
    "E2": {"lanes": 1 << 16, "ms": (1, 9), "check_lanes": None, "long_ms": None},
    "E3": {"lanes": 1 << 16, "ms": (1, 9), "check_lanes": None, "long_ms": None},
    "E4": {"lanes": 1 << 16, "check_lanes": None, "long_ms": None},
    "E5": {"lanes": 1 << 16, "check_lanes": None},
}


def run_all(device="cuda", cut: bool = False, only=None, lanes: int | None = None) -> list:
    """The records of the five probes (E1-E5, or those in `only`), at the
    full sizes or (cut) at CUT's, with every lane count `lanes` if given."""
    from . import kernel_variants, mul_kernel_bench, pallas_mul, redc_probe, vpu_mul_probe

    runs = {"E1": pallas_mul.run, "E2": redc_probe.run, "E3": vpu_mul_probe.run,
            "E4": mul_kernel_bench.run, "E5": kernel_variants.run}
    recs = []
    for probe, fn in runs.items():
        if only is None or probe in only:
            kw = dict(CUT[probe]) if cut else {}
            if lanes is not None:
                kw.update({k: lanes for k in ("lanes", "one_lanes", "chain_lanes")
                           if k in (CUT["E1"] if probe == "E1" else CUT["E2"])})
            recs += fn(device=device, **kw)
    return recs


def failures(recs: list) -> list:
    """The records whose kernel differs from its plain version (or, for E1,
    from the product it is set beside)."""
    return [r for r in recs if r["max_abs_err"] or r.get("equal_beside") is False]
