"""blaze_tpu_torch: the blaze_tpu framework on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `blaze_tpu`, which stays beside it as the
reference: multi-limb Montgomery field arithmetic, complete elliptic-curve
ops, the fused Pippenger MSM, the fused NTT (up to 2^27) and the Poseidon
8-ary Merkle tree behind the reference's five-phase `MSMClient`,
`NTTClient` and `PoseidonClient` lifecycles
(`blaze/src/driver_client/dclient.rs:24-46`).
Every Pallas kernel of those paths is a hand-written CUDA kernel for sm_90a
(`csrc/`), built with nvcc at first use (`_build.py`); each has a plain
PyTorch version beside it that CPU tensors run.  Entry points default to the
`cuda` device and raise when there is none, unless the caller passes
`device="cpu"`.

Citations such as `blaze/src/ingo_msm/msm_api.rs:72` point into the
upstream ingonyama-zk/blaze sources the framework re-implements.
"""

__version__ = "0.1.0"
