"""lastz_tpu_torch — the aligner on PyTorch and CUDA.

A second package beside `lastz_tpu`: the same CLI, options and output
bytes, with the device stages written for one NVIDIA H100 instead of a
TPU.  It stands alone: it imports neither JAX nor `lastz_tpu`.  Its
host layers are copies of lastz_tpu's at the same relative paths, with
the device routing pointed at this package:

  core/ io/ index/ filters/ out/ tools/ native/ masking.py infer.py
  config.py stats.py  host layers (lastz_tpu's, unchanged)
  device.py        device choice (LASTZ_TORCH_DEVICE) and the host-built
                   state uploaded to it
  kernels/build.py nvcc build of csrc/*.cu into a ctypes library
  csrc/            the hand-written Hopper kernels
  ops/             kernel wrappers beside their plain PyTorch versions
  align/           the accept loop and the batched device extension
  search/          the seed engines and the device seed-hit search
  pipeline.py      the run orchestration, on the host index build
  cli.py           `python -m lastz_tpu_torch.cli target query [options]`
"""

__version__ = "0.1.0"
