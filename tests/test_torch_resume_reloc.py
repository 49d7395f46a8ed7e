"""Resume through a relocalization event: tpuslam_torch's SlamSystem.run() split right after a rescue, on the CPU.

The reference's ``test_slam_resume_through_relocalization_event`` scenario
(``test_resume.py``), the noise injected in memory: the ten fixtures with
frames 4 and 5 replaced by noise, VO-SLAM at batch 4 with the flat
vocabulary at the relocalization shapes of ``test_torch_system_lc.py`` (K
512, 256 hypotheses, ratio test 0.8, inliers at 2 px, the pose graph off).
Frame 6 is rescued in the chunk before the split after frame 8; the
keyframe DB (with its stored poses) and the corrected chain pose are in the
checkpoint, so the split run equals the uninterrupted one bit for bit.  The
port alone, on one CPU thread; a file of its own so that xdist runs it
beside ``test_torch_resume.py``.
"""

import numpy as np

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_resume import SPLIT_AT, SPLIT_BATCH, batches, check_split, split_run
from test_torch_system_lc import _blind_config, blinded
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.pre.stream import FrameStream


def test_split_run_through_relocalization_equals_single_run(tmp_path, data_dir):
    cfg_dir = data_dir.parent.parent / "configs"
    stream = FrameStream(data_dir / "images")
    frames = blinded(np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)]))
    system = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                     _blind_config(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=SPLIT_BATCH)),
                     vocabulary=cfg_dir / "vocabulary.npz", enable_pose_graph=False, device="cpu")
    single = system.run(batches(frames, SPLIT_BATCH), seed=0)
    check_split(split_run(system, frames, SPLIT_AT, tmp_path), single)
    # the rescue happened before the split, and the chain jumped forward with it
    assert single["reloc_ok"][6] and not single["reloc_ok"][SPLIT_AT:].any()
    assert single["poses"][6, 2, 3] - single["poses"][3, 2, 3] > 1.5
