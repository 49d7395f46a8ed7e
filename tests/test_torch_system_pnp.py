"""The SLAM back end in PnP mode: tpuslam_torch's SlamSystem against tpuslam's on the CPU.

The run of ``test_torch_system.py`` (the 10 KITTI fixture frames, K 512,
256 two-view hypotheses, batch 5, ``ba_interval`` 3, the reference's draws
replayed) with ``tracking="pnp"``: every tracked frame is a keyframe, and
each BA window is the map the next chunk tracks against, its newest
keyframe the pose the chain continues from.  Held as that file's 4-step
case: integer fields and the BA schedule identical, costs, rotations and
positions at the float32-BA finding stated there (positions also 3e-4
relative, the PnP slice's tolerance).

The feedback itself is held tightly on the reference's own final PnP map:
``_refreshed_pose`` equal, and one more ``bundle_adjust`` on that map in
float64 to 1e-8.  (In float32 that BA's translations differ by 8.4e-3 at
|t| 9.3, 9e-4 relative: the finding of ``test_torch_ba.py``; the slice
above holds float32.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import assert_ba_close
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_ba import run_both as ba_both
from test_torch_system import check_multi_observations, check_system, run_both
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.convert import map_state_from_numpy


@pytest.fixture(scope="module")
def pnp_runs(data_dir):
    stream = FrameStream(data_dir / "images")
    frames = np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])
    return run_both(data_dir, frames, "pnp", tracking="pnp", ba_interval=3)


def test_pnp_system_matches_reference(pnp_runs):
    case, _, want, got = pnp_runs
    check_system(case, want, got)


def test_pnp_system_map_multi_observations(pnp_runs):
    check_multi_observations(pnp_runs[3])


def test_pnp_feedback_on_the_reference_map(pnp_runs, data_dir):
    """``_refreshed_pose`` and one more BA on the reference's own final PnP map."""
    jm = pnp_runs[1]["map"]
    tm = map_state_from_numpy(jax.tree.map(np.asarray, jm))
    fallback = np.diag([1.0, 2.0, 3.0, 1.0]).astype(np.float32)
    for ran in (True, False):
        want = JSystem._refreshed_pose(jm, jnp.asarray(ran), jnp.asarray(fallback))
        got = TSystem._refreshed_pose(tm, torch.tensor(ran), torch.from_numpy(fallback))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    K = np.asarray(TCamera.from_yaml(data_dir.parent.parent / "configs" / "camera.yml").K, np.float32)
    got, want = ba_both(jm, K, x64=True, iterations=4, active_points=512)
    assert_ba_close(got, want, x64=True)
