"""PyTorch/CUDA port of the stereo-VO main path of trackingbench_slam_tpu.

The JAX package (trackingbench_slam_tpu/) is the reference; this package
stands alone beside it: it imports torch and numpy, never jax and nothing of
the JAX package. Its three hand-written CUDA kernels (csrc/*.cu) replace the
three Pallas TPU kernels; everything XLA composed from plain ops is plain
PyTorch.

Precision: geometry, the solvers and the descriptor blur need true float32.
On Hopper a float32 convolution goes through cuDNN in TF32 by default, which
would move BRIEF bits, so both TF32 switches are pinned off here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
