"""PLI-SLAM in JAX — a stereo visual-inertial point+line SLAM framework.

A from-scratch JAX/XLA re-design of the capabilities of PLI-SLAM
(reference: VealFang/PLI-SLAM, a C++11 ORB-SLAM3 + PL-SLAM derivative):

- batched ORB point + line-segment extraction as XLA programs
  (reference: src/ORBextractor.cc, src/LineExtractor.cc);
- binary-descriptor (Hamming) matching as popcount-matmul kernels
  (reference: src/ORBmatcher.cc, src/LineMatcher.cpp);
- IMU preintegration as a `lax.scan` (reference: src/ImuTypes.cc);
- a single Gauss-Newton/Levenberg-Marquardt core over typed residual
  blocks replacing both g2o and the hand-rolled GN solver
  (reference: src/Optimizer.cc, Thirdparty/g2o);
- tracking / local mapping / loop closing as pipelined device programs
  orchestrated from the host instead of POSIX threads
  (reference: src/{Tracking,LocalMapping,LoopClosing}.cc);
- distributed Schur-complement bundle adjustment over a
  `jax.sharding.Mesh` (no analog in the reference, which is
  single-process shared-memory).

Data model inversion vs the reference: dense fixed-shape padded arrays
with validity masks everywhere (frames, landmark stores, observation
tables) instead of pointer graphs — see SURVEY.md §7.1.
"""

__version__ = "0.1.0"

from pli_slam_tpu.utils.config import SlamConfig  # noqa: F401
