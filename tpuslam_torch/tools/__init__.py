"""Command-line tools of the port: the soak and the stage profiles (``python -m tpuslam_torch.tools.<name>``)."""
