"""phdslam_tpu — Rao-Blackwellized (C)PHD-SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference CUDA implementation (Nat-zewge/cuda-PHDSLAM); see SURVEY.md.
"""

import jax as _jax

# The filter's linear algebra is tiny (2x2/4x4 covariances) and numerically
# sensitive (Joseph-form updates, Mahalanobis gates). On NVIDIA GPUs XLA may
# run f32 matmuls and einsums in TF32, which keeps about three decimal
# digits — enough to corrupt the EKF over long runs. Force full f32
# multiplies; the cost is irrelevant at these shapes.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import SlamConfig, load_config
from .types import FilterState, GMState, init_state

__all__ = ["SlamConfig", "load_config", "FilterState", "GMState",
           "init_state"]
__version__ = "0.1.0"
