from .ec import ECOracle
from .gen import class_sum_expected, random_msm_instance, tiled_msm_instance

__all__ = [
    "ECOracle",
    "class_sum_expected",
    "tiled_msm_instance",
    "random_msm_instance",
]
