"""lastz_tpu_torch — the aligner's device path on PyTorch and CUDA.

A second package beside `lastz_tpu`: the same CLI, options and output
bytes, with the device stages written for one NVIDIA H100 instead of
a TPU.  The host layers (I/O, scoring, seeds, the host index build,
the accept loop, the output writers) are imported from `lastz_tpu`
unchanged; this package owns only what touches the device:

  device.py        device choice (LASTZ_TORCH_DEVICE) and the host-built
                   state uploaded to it
  kernels/build.py nvcc build of csrc/*.cu into a ctypes library
  csrc/            the hand-written Hopper kernels
  ops/             kernel wrappers beside their plain PyTorch versions
  align/           batched device gapped extension + the accept loop
  search/          device seed-hit search and the engine that routes to it
  pipeline.py      the pipeline with the device routing swapped in
  cli.py           `python -m lastz_tpu_torch.cli target query [options]`

Nothing here imports JAX.
"""

__version__ = "0.1.0"
