"""pycsou_tpu_torch — the PyTorch/CUDA port of pycsou_tpu for NVIDIA Hopper.

Same subpackage layout and public names as ``pycsou_tpu`` (the JAX
reference), so each counterpart is found under the same path.  Plain tensor
code is PyTorch; the hot kernels are CUDA C++ under ``csrc/``, built for
``sm_90a`` on first use (``kernels/_build.py``).

The port runs on the CUDA card unless the caller asks for the CPU:
constructors take ``device=``, else the device of the tensors they are
given, else the port's default (``set_default_device("cpu")`` for a CPU
run), else ``cuda``; without CUDA that last case raises.  Nothing moves
work between CPU and GPU on its own.
Importing the package changes no global PyTorch setting: the plain
versions' convolutions switch TF32 off only for their own calls
(``utils.device.full_f32``), because TF32 would change the operators.  It
makes one first call of the CPU's vector math on one thread
(``utils.device.settle_cpu_math``), so that a first parallel call cannot
race MKL's choice of code path.
"""
__version__ = "0.1.0"

from pycsou_tpu_torch.utils.device import settle_cpu_math  # noqa: E402

settle_cpu_math()

from pycsou_tpu_torch.opt import (  # noqa: E402
    APGD,
    CPS,
    DRS,
    FBS,
    PDS,
    PMYULA,
    LassoDeconvolution,
    TVDeconvolution,
)
from pycsou_tpu_torch.parallel import DistributedTVDeconv2D, Mesh, make_mesh  # noqa: E402
from pycsou_tpu_torch.utils.device import get_default_device, set_default_device  # noqa: E402

__all__ = ["APGD", "CPS", "DRS", "DistributedTVDeconv2D", "FBS", "Mesh", "PDS", "PMYULA",
           "LassoDeconvolution", "TVDeconvolution", "get_default_device", "make_mesh",
           "set_default_device"]
