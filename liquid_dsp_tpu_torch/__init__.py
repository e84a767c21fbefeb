"""liquid_dsp_tpu_torch — the PyTorch + CUDA port of liquid_dsp_tpu.

The same streaming DSP framework on torch tensors, for an NVIDIA H100:
every op is a `Proc` (`torch.nn.Module`) with an explicit block carry,
``y, carry' = proc(carry, x)``.  Module paths mirror `liquid_dsp_tpu`;
the port imports torch and never jax.  The TPU's Pallas kernels become
hand-written CUDA kernels (`ops/kernels`, sources in `csrc/`), built with
nvcc on first use.

Package layout:
  core        — Proc / Chain / LTI
  design/     — host-side coefficient design (numpy float64)
  ops/        — streaming ops (fir, fftfilt, resample, nco, agc, symsync,
                equalize)
  ops/kernels — CUDA kernels with their plain PyTorch versions
  fuse, planar — chain transforms; convert — state to and from JAX
  fec/, framing/, modem/, multichannel/, utils/ — as in liquid_dsp_tpu
  io — IQ capture formats; runtime — StreamRunner, the production loop
  trace — the block step's spans, recorded while torch.profiler records
  compat — the reference C library's names
"""

__version__ = "0.1.0"   # the JAX package's

from .core import LTI, Chain, Proc, chain  # noqa: F401
from .fuse import fuse, fused_fir, kernel_fuse  # noqa: F401
from .planar import planar, to_planes, from_planes  # noqa: F401
