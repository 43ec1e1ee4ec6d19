"""Sequential (video) reconstruction: windowed incremental SfM (PyTorch).
Counterpart of vggsfm_tpu/video (reference vggsfm/runners/video_runner.py):
an initial sparse solve on the first window, then per window: track the
existing 3D points + fresh query points into the new frames, register the
new frames against the fixed map (PnP + pose refinement), triangulate new
points, run a windowed BA with old poses/points frozen, and periodically a
joint BA over everything, solved by the sparse implicit-Schur LM
(ba/sparse_lm.py) instead of CPU Ceres (video_runner.py:1321-1331).
"""

from vggsfm_tpu_torch.video.runner import VideoRunner, VideoConfig
