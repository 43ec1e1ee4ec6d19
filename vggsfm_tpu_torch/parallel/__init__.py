"""Multi-device and multi-host pieces of the port, on `torch.distributed`
(counterpart of vggsfm_tpu/parallel/):

  * ``points`` — query tracks: the tracker, triangulation LORANSAC and the
    BA point blocks are parallel per track; the virtual tracks'
    attention over the point tokens and the reduced camera system sum
    over the axis (parallel/sharded.py);
  * ``frames`` — images: the feature CNN runs on each rank's frames;
  * the joint BA of the video pipeline shards its observations
    (parallel/multihost.py), and the multi-host run merges its hosts'
    maps through files (parallel/merge.py).
"""

from vggsfm_tpu_torch.parallel.mesh import make_mesh
from vggsfm_tpu_torch.parallel.sharded import (
    sharded_pipeline_step,
    sharded_track_and_reconstruct,
)
