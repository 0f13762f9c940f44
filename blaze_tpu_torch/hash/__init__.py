from .params import PoseidonParams, generate_params, params_from_csv, params_from_reference
from .kernels import PoseidonKernels
from .poseidon import Poseidon
from .tree import (
    MerkleTreeBuilder,
    TreeMode,
    TreeResult,
    num_tree_nodes,
    base_layer_size,
    ARITY,
    LEAF_ARITY,
)

__all__ = [
    "PoseidonParams",
    "generate_params",
    "params_from_csv",
    "params_from_reference",
    "PoseidonKernels",
    "Poseidon",
    "MerkleTreeBuilder",
    "TreeMode",
    "TreeResult",
    "num_tree_nodes",
    "base_layer_size",
    "ARITY",
    "LEAF_ARITY",
]
