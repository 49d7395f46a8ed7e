"""tpuslam_torch.config"""
