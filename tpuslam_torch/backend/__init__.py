"""tpuslam_torch.backend"""
