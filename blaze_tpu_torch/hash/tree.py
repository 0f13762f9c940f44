"""8-ary Poseidon Merkle tree builder.

Behavioral parity with the reference's tree engine:
  * 8-ary tree of the given height; base layer has 8^(height-1) nodes and
    the total is sum_i 8^i, i < height — 585 nodes for height 4
    (`/root/reference/src/ingo_hash/utils.rs:2-14`,
    `tests/integration_poseidon.rs:23,165`);
  * TreeC mode column-hashes 11 input elements per leaf (the 11-element
    feed loop at integration_poseidon.rs:151-155; t=12 sponge), TreeD mode
    takes leaves directly (`utils.rs:16-30` TreeMode);
  * results are (hash, layer_id, hash_id) records mirroring
    PoseidonResult::parse_poseidon_hash_results (poseidon_api.rs:42-71).

One algorithm, the JAX package's fused lanes-major path: a level is a
(W, count) Montgomery tensor, the leaf sponge is one K10 launch over
(12, W, 8^(h-1)) states with the canonical -> Montgomery conversion folded
in, and each node level one K10 launch over (9, W, count/8) states.  Layers
stay lanes-major Montgomery on the device until drained; `from_mont` (K1)
runs at drain time.
"""
from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from ..fields.spec import FieldSpec, int_to_words
from ..trace import span
from .params import PoseidonParams, generate_params
from .poseidon import Poseidon

ARITY = 8
LEAF_ARITY = 11  # elements column-hashed into one leaf (TreeC)
DOMAIN_TAG = 0   # state[0] of every leaf and node sponge


class TreeMode(enum.IntEnum):
    # values match the reference's start-layer encoding (utils.rs:16-30)
    TREE_C = 0
    TREE_D = 1


def num_tree_nodes(height: int) -> int:
    """Sum of 8^i for i < height (utils.rs:2-10)."""
    return sum(ARITY**i for i in range(height))


def base_layer_size(height: int) -> int:
    """8^(height-1) (utils.rs:12-14)."""
    return ARITY ** (height - 1)


class TreeResult:
    """All tree nodes, leaf layer first; mirrors the drained result records.

    Layers are (W, count) Montgomery DEVICE tensors until drained: the
    launches are asynchronous on the CUDA stream, like the reference's
    streaming engine that emits internal layers while leaves are still
    being fed (integration_poseidon.rs:81-119).  `layers`, `records()` and
    `root` convert (K1) and transfer; `block_until_ready()` is the
    wait_result hook.  `task_label`, where a client sets it, labels the
    root's span.
    """

    def __init__(self, layers_lm_mont: list, field):
        self._lm = layers_lm_mont
        self._field = field
        self._layers: Optional[list] = None
        self.task_label = None

    @property
    def layers(self) -> list:
        """(count, W) canonical int32 words per layer, leaf layer first, on
        the layers' device."""
        if self._layers is None:
            self._layers = [self._field.from_mont(l.t().contiguous()) for l in self._lm]
        return self._layers

    def block_until_ready(self) -> None:
        dev = self._lm[-1].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def host_layers(self) -> list:
        """(count, W) canonical uint32 words per layer, on the host."""
        return [l.cpu().numpy().view(np.uint32) for l in self.layers]

    def records(self) -> list:
        """(hash_words, layer_id, hash_id) triples, streaming order."""
        return [(h, lid, hid) for lid, layer in enumerate(self.host_layers())
                for hid, h in enumerate(layer)]

    @property
    def root(self) -> np.ndarray:
        with span("blaze.tree.root", self.task_label):
            return self.layers[-1][0].cpu().numpy().view(np.uint32)

    def __len__(self) -> int:
        return sum(l.shape[1] for l in self._lm)


class MerkleTreeBuilder:
    """Level-synchronous 8-ary tree builder over the fused permutation.

    `device` is where numpy inputs go (the card unless the caller asks for
    the CPU); tensor inputs stay on their own device."""

    def __init__(
        self,
        spec: FieldSpec,
        leaf_params: PoseidonParams | None = None,
        node_params: PoseidonParams | None = None,
        device=None,
    ):
        self.spec = spec
        self.leaf_params = leaf_params or generate_params(spec, LEAF_ARITY + 1)
        self.node_params = node_params or generate_params(spec, ARITY + 1)
        self.leaf_hasher = Poseidon(self.leaf_params)
        self.node_hasher = Poseidon(self.node_params)
        self.field = self.leaf_hasher.field
        self.device = torch.device(device or "cuda")

    def _tag(self, mont: bool, B: int, device) -> torch.Tensor:
        """(1, W, B) domain-tag row.  convert_in multiplies the WHOLE leaf
        state by R^2, so the leaf tag enters in canonical form and the node
        tag in Montgomery form (tag 0 is 0 either way)."""
        spec = self.spec
        v = DOMAIN_TAG * spec.r % spec.p if mont else DOMAIN_TAG % spec.p
        w = torch.from_numpy(int_to_words(v, spec.nwords).view(np.int32)).to(device)
        return w[None, :, None].expand(1, spec.nwords, B)

    # ------------------------------------------------------------ pieces
    def hash_leaves_staged(self, cols_lm: torch.Tensor) -> torch.Tensor:
        """Fused leaf sponge: (LEAF_ARITY, W, Bc) canonical lanes-major ->
        (W, Bc) Montgomery leaf hashes (asynchronous on the card)."""
        A, W, Bc = cols_lm.shape
        if A != LEAF_ARITY or W != self.spec.nwords:
            raise ValueError(f"want ({LEAF_ARITY}, {self.spec.nwords}, B), got "
                             f"{tuple(cols_lm.shape)}")
        with span("blaze.tree.leaves"):
            state = torch.cat([self._tag(False, Bc, cols_lm.device), cols_lm])
            self.leaf_hasher.kern.permute_lm(state, convert_in=True, out=state)
            return state[1].clone()

    def close_staged(self, leaf_lm: torch.Tensor, height: int) -> TreeResult:
        """Node levels over a complete (W, B) Montgomery leaf layer."""
        W, B = leaf_lm.shape
        if B != base_layer_size(height):
            raise ValueError(f"want B={base_layer_size(height)}, got {B}")
        layer, layers = leaf_lm, [leaf_lm]
        knode = self.node_hasher.kern
        while layer.shape[1] > 1:
            with span("blaze.tree.level"):
                Bc = layer.shape[1] // ARITY
                grouped = layer.reshape(W, Bc, ARITY).permute(2, 0, 1)   # (8, W, Bc)
                state = torch.cat([self._tag(True, Bc, layer.device), grouped])
                knode.permute_lm(state, out=state)
                layer = state[1].clone()
            layers.append(layer)
        return TreeResult(layers, self.field)

    def build_staged(self, leaf_cols_lm: torch.Tensor, height: int) -> TreeResult:
        """TREE_C build over PRE-STAGED lanes-major canonical columns
        (LEAF_ARITY, W, 8^(h-1)), already on their device: one leaf launch,
        then one launch per node level."""
        if leaf_cols_lm.shape[2] != base_layer_size(height):
            raise ValueError(f"want ({LEAF_ARITY}, W, {base_layer_size(height)}), "
                             f"got {tuple(leaf_cols_lm.shape)}")
        return self.close_staged(self.hash_leaves_staged(leaf_cols_lm), height)

    def build(self, elements, height: int, mode: TreeMode = TreeMode.TREE_C) -> TreeResult:
        """elements: canonical int32/uint32 words, a tensor (which stays on
        its device) or a numpy array (sent to the builder's device) —
        TREE_C: (8^(h-1), 11, W) column elements;
        TREE_D: (8^(h-1), W) precomputed leaves (to_mont on K1, then the
        node levels)."""
        arr = (elements if isinstance(elements, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(elements, dtype=np.uint32).view(np.int32)).to(self.device))
        nleaves, W = base_layer_size(height), self.spec.nwords
        if mode == TreeMode.TREE_C:
            if arr.shape != (nleaves, LEAF_ARITY, W):
                raise ValueError(f"TreeC wants ({nleaves}, {LEAF_ARITY}, {W}), "
                                 f"got {tuple(arr.shape)}")
            return self.build_staged(arr.permute(1, 2, 0).contiguous(), height)
        if arr.shape != (nleaves, W):
            raise ValueError(f"TreeD wants ({nleaves}, {W}), got {tuple(arr.shape)}")
        return self.close_staged(self.field.to_mont(arr.contiguous()).t().contiguous(),
                                 height)
