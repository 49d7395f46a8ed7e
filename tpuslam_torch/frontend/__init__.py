"""tpuslam_torch.frontend"""
