"""tpuslam_torch.post"""
