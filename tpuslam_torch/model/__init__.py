"""tpuslam_torch.model"""
