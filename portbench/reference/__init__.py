"""The plain reference of the batched VO step that the benchmark judges the port against.

Plain PyTorch and NumPy only.  It imports nothing of the port, of JAX or of
the JAX package: it is a frozen copy of the arithmetic the port's VO step
is specified by (the plain twins of the five CUDA kernels, the matcher,
the two-view RANSAC, triangulation, depth-ratio scale and pose chaining),
so a later change to the port cannot move it.  It reads its parameters
from the configuration's JSON file under ``portbench/configs/`` and works
out every derived array (undistortion map, BRIEF pattern, bin weights,
resize taps, random draws) again from them.
"""
