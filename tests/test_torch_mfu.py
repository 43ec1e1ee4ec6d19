"""The port's kernel FLOP formulas and its parity harness
(vggsfm_tpu_torch/parity_check.py), on the CPU.

Each hand-written kernel has one FLOP formula (ops/fused_mlp.py
`*_flops`, ops/corr.py `corr_flops`), which the benchmark's own copies are
held to (benchmark/tests/test_bench_work.py): the formula must equal what
FlopCounterMode counts of the kernel's plain version. The audit runs on a
checkpoint of the reference key set (tests/fixtures/vggsfm_v2_keys.json)
saved as broadcast views, ~0.2 MB; the scene run and fixture diff on the
4 x 128 px scene of tests/test_torch_runner_export.py with its tiny camera
predictor.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vggsfm_tpu_torch import parity_check as pc
from vggsfm_tpu_torch import runner as trun
from vggsfm_tpu_torch.models import CameraPredictor, TrackerPredictor
from vggsfm_tpu_torch.models import init_tracker_
from vggsfm_tpu_torch.ops import corr as cm
from vggsfm_tpu_torch.ops import fused_mlp as fm
from vggsfm_tpu_torch.utils import synth as tsynth

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "vggsfm_v2_keys.json")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: beside the other test workers, more threads
    only oversubscribe the cores. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the kernels

def _former_args(g, R, C, M, dtype):
    def r(*s):
        return (torch.randn(*s, generator=g) * 0.1).to(dtype)

    return dict(x=r(R, C), w_in=r(3 * C, C), b_in=r(3 * C), w_out=r(C, C),
                b_out=r(C), w1=r(M, C), b1=r(M), w2=r(C, M), b2=r(C))


def _kernel_cases(kind, dtype):
    g = torch.Generator().manual_seed(0)
    R, C, M, L, H = 24, 32, 128, 8, 4
    a = _former_args(g, R, C, M, dtype)
    if kind == "fused_transformer_block":
        args = (a["x"], a["w_in"], a["b_in"], a["w_out"], a["b_out"],
                a["w1"], a["b1"], a["w2"], a["b2"], L, H)
        return (fm.fused_transformer_block_ref, args,
                fm.block_flops(R, C, M, L))
    if kind == "fused_ln_mlp":
        args = (a["x"], a["w1"], a["b1"], a["w2"], a["b2"])
        return fm.fused_ln_mlp_ref, args, fm.ln_mlp_flops(R, C, M)
    if kind == "fused_ln_attn":
        args = (a["x"], a["w_in"], a["b_in"], a["w_out"], a["b_out"], L, H)
        return fm.fused_ln_attn_ref, args, fm.ln_attn_flops(R, C, L)
    F, N, Cc, rad = 3, 5, (16 if kind.endswith("smallc") else 128), 2
    maps = torch.randn(F, 9, 7, Cc, generator=g).to(dtype)
    levels = [maps, torch.randn(F, 4, 3, Cc, generator=g).to(dtype)]
    if kind.endswith("smallc"):  # the flat channel-first layout
        levels = [lv.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                  for lv in levels]
    coords = torch.rand(F, N, 2, generator=g) * 8
    feats = torch.randn(F, N, Cc, generator=g).to(dtype)
    args = (levels, coords, feats, rad)
    return cm.corr_sample_plain, args, cm.corr_flops(F, N, Cc, rad, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["fused_transformer_block", "fused_ln_mlp",
                                  "fused_ln_attn", "corr_sample_pallas",
                                  "corr_sample_pallas_smallc"])
def test_kernel_formula_is_the_plain_versions_count(kind, dtype):
    """formula == FlopCounterMode's count of the plain version."""
    ref, args, formula = _kernel_cases(kind, dtype)
    with FlopCounterMode(display=False) as counter:
        ref(*args)
    assert counter.get_total_flops() == formula


# ------------------------------------------------------------ parity_check

def _manifest_checkpoint(path, drop=None, add=None):
    with open(FIXTURE) as f:
        man = json.load(f)["keys"]
    sd = {k: torch.zeros(()).expand(v) for k, v in man.items() if k != drop}
    if add:
        sd[add] = torch.zeros(3)
    torch.save(sd, path)
    return path


def test_parity_check_audit_passes_on_the_reference_key_set(tmp_path,
                                                            capsys):
    ck = _manifest_checkpoint(str(tmp_path / "ck.pt"))
    out = str(tmp_path / "report.json")
    assert pc.main(["--checkpoint", ck, "--convert-only", "--out", out,
                    "--device", "cpu"]) == 0
    with open(out) as f:
        rep = json.load(f)["conversion"]
    assert rep["ok"] and rep["total_keys"] == rep["consumed_keys"] == 690
    assert not rep["missing_keys"] and not rep["unexpected_keys"]


def test_parity_check_audit_names_a_missing_and_an_unexpected_key(
        tmp_path, capsys):
    drop = "track_predictor.fine_fnet.conv2.bias"
    add = "camera_predictor.extra_head.weight"
    ck = _manifest_checkpoint(str(tmp_path / "ck.pt"), drop=drop, add=add)
    assert pc.main(["--checkpoint", ck, "--device", "cpu"]) == 1
    rep = json.loads(capsys.readouterr().out)["conversion"]
    assert rep["missing_keys"] == [drop]
    assert rep["unexpected_keys"] == [add]
    assert not rep["ok"]


def test_parity_check_fixture_write_then_diff(tmp_path, monkeypatch, capsys):
    """The scene run on the 4 x 128 px scene folder (tiny camera predictor,
    seeded weights, query frame 0 only, f32, no re-query): the first run writes the
    fixtures, the second diffs against them (AUC@30 1.0, exit 0); against
    fixtures whose cameras moved the diff misses the gate."""
    small = functools.partial(CameraPredictor, hidden_size=64, num_heads=4,
                              down_size=28, att_depth=2, trunk_depth=2)
    monkeypatch.setattr(trun, "CameraPredictor", small)
    monkeypatch.setattr("vggsfm_tpu_torch.models.CameraPredictor", small)
    monkeypatch.setattr(trun.VGGSfMRunner, "select_query_frames",
                        lambda self, images: [0])
    # f32, no re-query rounds: bf16 matmuls crawl on the CPU, and seeded
    # weights leave every frame short of visible tracks
    monkeypatch.setattr(trun, "RunnerConfig", functools.partial(
        trun.RunnerConfig, precision="f32", comple_nonvis=False))
    scene_dir = str(tmp_path / "scene")
    tsynth.write_scene_folder(tsynth.render_two_plane_scene(4, 128, seed=3),
                              scene_dir)
    g = torch.Generator().manual_seed(0)
    tracker = TrackerPredictor()
    init_tracker_(tracker, g)
    camera = small()
    with torch.no_grad():
        for p in camera.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    sd = {f"track_predictor.{k}": v for k, v in tracker.state_dict().items()}
    sd.update({f"camera_predictor.{k}": v
               for k, v in camera.state_dict().items()})
    fix = str(tmp_path / "fixtures")
    argv = ["--scene", scene_dir, "--fixtures", fix, "--img-size", "128",
            "--query-method", "sift+harris", "--max-query-pts", "64",
            "--query-frame-num", "1", "--device", "cpu"]
    assert pc.main(argv + ["--write-fixtures"], state_dict=sd) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["fixtures_written"] == fix and rep["scene"]["num_frames"] == 4
    assert sorted(os.listdir(fix)) == ["extrinsics.npy", "intrinsics.npy",
                                       "points3d.npy", "valid_tracks.npy"]
    assert pc.main(argv, state_dict=sd) == 0
    diff = json.loads(capsys.readouterr().out)["fixture_diff"]
    assert diff["auc30_vs_fixture"] == 1.0
    # the gate: the same run against fixtures whose cameras moved
    res = {k: np.load(os.path.join(fix, f"{k}.npy"))
           for k in ("extrinsics", "valid_tracks")}
    extr = res["extrinsics"].copy()
    c, s = np.cos(0.7), np.sin(0.7)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    extr[1:, :, :3] = rot @ extr[1:, :, :3]
    np.save(os.path.join(fix, "extrinsics.npy"), extr)
    assert pc.diff_fixtures(res, fix)["auc30_vs_fixture"] < 0.85
