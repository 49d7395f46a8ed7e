"""tpuslam_torch.pre"""
