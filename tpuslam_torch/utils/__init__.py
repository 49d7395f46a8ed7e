"""tpuslam_torch.utils"""
