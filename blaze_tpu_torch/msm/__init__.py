from .pippenger import MSM, MSMConfig, default_window_bits
from .precompute import precompute_points, shift_bits_for, split_scalars
from .residency import (
    from_reference_resident,
    points_from_resident,
    points_to_resident,
    scalars_to_resident,
    to_reference_resident,
)

__all__ = [
    "MSM",
    "MSMConfig",
    "default_window_bits",
    "precompute_points",
    "shift_bits_for",
    "split_scalars",
    "from_reference_resident",
    "points_from_resident",
    "points_to_resident",
    "scalars_to_resident",
    "to_reference_resident",
]
