"""tpuslam_torch.dist"""
