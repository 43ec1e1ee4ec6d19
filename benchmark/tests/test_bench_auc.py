"""The frozen AUC against the port's calculate_auc."""

import pytest
import torch

from benchmark.harness.auc import pose_auc
from vggsfm_tpu_torch.geometry.metrics import (
    calculate_auc,
    relative_pose_errors,
)
from vggsfm_tpu_torch.geometry.rotations import axis_angle_to_matrix


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_threshold", [5, 30])
def test_auc_matches_the_port(seed, max_threshold):
    g = torch.Generator().manual_seed(seed)
    S = 8
    R1 = axis_angle_to_matrix(torch.randn(S, 3, generator=g) * 0.3)
    t1 = torch.randn(S, 3, 1, generator=g)
    R2 = axis_angle_to_matrix(torch.randn(S, 3, generator=g) * 0.03) @ R1
    t2 = t1 + torch.randn(S, 3, 1, generator=g) * 0.05
    gt, pred = torch.cat([R1, t1], -1), torch.cat([R2, t2], -1)
    r, t, m = relative_pose_errors(pred, gt)
    want = float(calculate_auc(r, t, mask=m, max_threshold=max_threshold))
    assert pose_auc(pred, gt, max_threshold) == pytest.approx(want,
                                                              abs=1e-6)


def test_auc_of_exact_cameras_is_one():
    g = torch.Generator().manual_seed(3)
    R = axis_angle_to_matrix(torch.randn(5, 3, generator=g))
    extr = torch.cat([R, torch.randn(5, 3, 1, generator=g)], -1)
    assert pose_auc(extr, extr) == pytest.approx(1.0)
