"""Batched Poseidon permutation and sponge hash.

The compute core the reference's FPGA hash engine performs opaquely
(`/root/reference/src/ingo_hash/poseidon_api.rs`): x^5 S-box, MDS mix,
round-constant adds.  One algorithm: every permutation is K10's fused
permutation (hash/kernels.py) through its points-major adapter, the kernel
for CUDA tensors and its plain version for CPU tensors.  Elements are
(..., W) int32 Montgomery words.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.mont import Field
from ..fields.spec import int_to_words
from .kernels import PoseidonKernels
from .params import PoseidonParams


class Poseidon:
    def __init__(self, params: PoseidonParams):
        self.params = params
        self.field = Field(params.spec)
        self.kern = PoseidonKernels.for_params(params)

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """(..., t, W) Montgomery -> (..., t, W)."""
        return self.kern.permute_pm(state)

    def hash(self, inputs: torch.Tensor, domain_tag: torch.Tensor) -> torch.Tensor:
        """One-shot sponge: state = [domain_tag, inputs...]; out = state[1].

        inputs: (..., rate, W) Montgomery.  domain_tag: (W,) Montgomery."""
        batch, W = inputs.shape[:-2], inputs.shape[-1]
        tag = domain_tag.to(inputs.device).expand(*batch, 1, W)
        return self.permute(torch.cat([tag, inputs], dim=-2))[..., 1, :]

    def domain_tag(self, value: int, device="cpu") -> torch.Tensor:
        """Montgomery-form (W,) constant for a python-int tag."""
        spec = self.params.spec
        words = int_to_words(value * spec.r % spec.p, spec.nwords)
        return torch.from_numpy(words.view(np.int32)).to(device)
