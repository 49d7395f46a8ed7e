"""tpuslam_torch.common"""
