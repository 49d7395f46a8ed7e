"""tpuslam_torch — the PyTorch/CUDA port of ``tpuslam`` for one NVIDIA H100.

The package mirrors ``tpuslam``'s layout module for module: plain tensor
code is PyTorch (eager, explicit ``device`` arguments, explicit
``torch.Generator``s), and every Pallas kernel on the VO main path is a
hand-written CUDA kernel under ``csrc/``, built for ``sm_90a`` at first use
and bound through ``ctypes`` (``kernels/``).  Each kernel wrapper runs its
plain PyTorch twin when handed CPU tensors, so the whole package runs (and
is tested against ``tpuslam``) on a CPU-only machine.

Float32 matrix products must be true float32: the reference pins
``precision="highest"`` on every solver product, and several integer-valued
products here (bit-plane Hamming, int8 moments, BRIEF one-hot dots) are
exact only without TF32.  Importing the package turns TF32 off.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
