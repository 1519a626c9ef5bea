"""infinitam_tpu_torch — the PyTorch + CUDA port of infinitam_tpu for NVIDIA H100.

The JAX package `infinitam_tpu` stays the reference: every module here mirrors
its counterpart's name and function names, and `tests/test_torch_*.py` hold
each one to it on the CPU. The three Pallas kernels of the main path are
hand-written CUDA C++ under `csrc/`, wrapped in `ops/kernels/`; a CPU tensor
takes each kernel's plain PyTorch version, a CUDA tensor the kernel. On the
card each frame step runs as one captured CUDA graph, the counterpart of the
JAX package's `jax.jit` (`engine/captured.py`).

The port imports nothing of the JAX package: `config` and `calib` are its
own copies of the reference's framework-free modules, held equal to them by
tests/test_torch_config.py.

Arithmetic is float32 throughout. TF32 is switched off for matmuls and cuDNN:
reduced-precision products break pose accuracy (the tracker's 6×6 normal
equations and 4×4 pose products need full float32).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
