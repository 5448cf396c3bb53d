"""sdtpu_torch — the PyTorch/CUDA port of sdtpu for NVIDIA Hopper.

A second package beside `sdtpu/`, mirroring its layout (`ops/`,
`models/`, `diffusion/`, `pipeline.py`) and its function names, so each
module's JAX counterpart is easy to find. `sdtpu/` stays the reference:
the tests hold every module of this package against it on the same
inputs and weights.

This package imports torch and never jax. From sdtpu it imports only
the pure-Python `sdtpu.config` and `sdtpu.tokenizer`, which pull in no jax
and which it re-exports as `sdtpu_torch.config` and
`sdtpu_torch.tokenizer`, so that callers of the port import nothing else.

Layouts follow sdtpu at every public function: NHWC activations, HWIO
conv weights, `[in, out]` linears, and the reference dump-tree parameter
names. Every sdtpu Pallas kernel on the ported path is a hand-written
CUDA kernel for sm_90a (`csrc/`), built at first use by
`sdtpu_torch.kernels`; each sits beside a plain PyTorch version that its
wrapper runs for CPU tensors.
"""

__version__ = "0.1.0"
