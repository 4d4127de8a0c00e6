"""datmo_using_optical_flow — DATMO framework on JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the CARLA LiDAR
DATMO research stack ``anvithaanchala/DATMO_using_Optical_flow``:

* **Pipeline A** (reference ``Optical_flow/main.py``): BEV rasterization +
  pyramidal Farnebäck dense optical flow + continuity/propagation masking +
  DBSCAN motion clustering + per-track EKFs with M/N lifecycle.
* **Pipeline B** (reference ``GMFA/GMFA.py``): ICP ego-motion compensation +
  residual-motion point classification + static occupancy mapping +
  Hungarian track association + Kalman tracking.

Where the reference delegates hot kernels to C++ libraries (OpenCV Farnebäck,
Open3D RANSAC/ICP/KD-tree, sklearn DBSCAN, SciPy Hungarian), this framework
implements on-device equivalents (jnp + Pallas) so the frame→tracks path
never leaves the device.  Host-side runtime pieces (PCD decode, frame streaming)
have native C++ implementations under ``native/`` with pure-Python fallbacks.
"""

__version__ = "0.1.0"

from datmo_using_optical_flow.config import (  # noqa: F401
    PipelineAConfig,
    GMFAConfig,
    load_config,
)
