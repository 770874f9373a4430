"""pycsou_tpu_torch — the PyTorch/CUDA port of pycsou_tpu for NVIDIA Hopper.

Same subpackage layout and public names as ``pycsou_tpu`` (the JAX
reference), so each counterpart is found under the same path.  Plain tensor
code is PyTorch; the hot kernels are CUDA C++ under ``csrc/``, built for
``sm_90a`` on first use (``kernels/_build.py``).

The device is always explicit: constructors take ``device=`` or the device
of the tensors they are given, and nothing moves work between CPU and GPU.
Importing the package changes no global PyTorch setting: the plain
versions' convolutions switch TF32 off only for their own calls
(``utils.device.full_f32``), because TF32 would change the operators.
"""
__version__ = "0.1.0"
