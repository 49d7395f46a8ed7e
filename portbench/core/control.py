"""The control: the plain reference put in the program's place, one precision below the configuration's.

The configuration states float32 with TF32 off.  TF32 reaches no bit of
this step (every float32 product has an inner dimension of 2 to 9, which
cuBLAS runs without tensor cores, or is a product of 0/1 bits, exact in
TF32), so the control takes the next step down, bfloat16, where it would
tempt a later change: the hypothesis scores (kernel 4's work) on bfloat16
operands with float32 products and sums, as tensor cores compute them.
The control sits behind the same
``initial_state`` / ``process_chunks`` interface as the port's
``SlamPipeline``, so the window drives it and the check judges it exactly
as it judges the program.  It has to come out not correct.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frontend import Keypoints
from portbench.reference.vo import Carry, ReferenceVO


class ControlState(NamedTuple):
    prev_kps: Keypoints
    prev_desc: torch.Tensor
    prev_exists: torch.Tensor
    pose: torch.Tensor
    frame_idx: int
    prev_depth: torch.Tensor
    prev_depth_valid: torch.Tensor


class ControlResult(NamedTuple):
    poses: torch.Tensor
    num_inliers: torch.Tensor
    pose_ok: torch.Tensor
    kps_xy: torch.Tensor
    kps_valid: torch.Tensor
    desc: torch.Tensor
    m_train: torch.Tensor
    m_valid: torch.Tensor


class ControlPipeline:
    def __init__(self, cell, device: str, group: int = 4):
        self.ref = ReferenceVO(cell.params, device, torch.bfloat16)
        self.group = group

    def initial_state(self) -> ControlState:
        kps, desc, exists = self.ref.empty(1)
        carry = self.ref.initial_carry(1)
        return ControlState(Keypoints(*(a[0] for a in kps)), desc[0], exists[0], carry.pose[0], 0, carry.depth[0],
                            carry.depth_valid[0])

    def process_chunks(self, frames, frame_valid, states, seeds):
        if not bool(torch.as_tensor(frame_valid).all()):
            raise ValueError("the control takes whole chunks")
        results, new_states = [], []
        for g in range(0, len(states), self.group):
            st = states[g : g + self.group]
            prev = (Keypoints(*(torch.stack(a) for a in zip(*(s.prev_kps for s in st)))),
                    torch.stack([s.prev_desc for s in st]), torch.stack([s.prev_exists for s in st]))
            carry = Carry(torch.stack([s.pose for s in st]), torch.stack([s.prev_depth for s in st]),
                          torch.stack([s.prev_depth_valid for s in st]))
            r = self.ref.step(frames[g : g + len(st)], prev, carry, [s.frame_idx for s in st], seeds[g : g + len(st)])
            B = r.poses.shape[1]
            for i, s in enumerate(st):
                results.append(ControlResult(r.poses[i], r.num_inliers[i], r.success[i], r.kps.xy[i],
                                             r.kps.valid[i], r.desc[i], r.train_idx[i], r.mvalid[i]))
                new_states.append(ControlState(Keypoints(*(a[i, -1] for a in r.kps)), r.desc[i, -1],
                                               torch.ones((), dtype=torch.bool, device=r.desc.device),
                                               r.carry.pose[i], s.frame_idx + B, r.carry.depth[i],
                                               r.carry.depth_valid[i]))
        return results, new_states
