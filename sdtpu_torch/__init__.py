"""sdtpu_torch — the PyTorch/CUDA port of sdtpu for NVIDIA Hopper.

A second package beside `sdtpu/`, mirroring its layout (`ops/`,
`models/`, `diffusion/`, `pipeline.py`) and its function names, so each
module's JAX counterpart is easy to find. `sdtpu/` stays the reference:
the tests hold every module of this package against it on the same
inputs and weights.

This package imports torch and never jax, and nothing of `sdtpu`, not
even its pure-Python modules: it keeps its own copies of what it needs
(`sdtpu_torch.config`, `sdtpu_torch.tokenizer` with its vocabulary in
`data/`, the UNet's spec tables). Its entry points run on the card unless
the caller asks for the CPU (`weights.init_params(..., device="cpu")`, the
`cpu` device argument of `python -m sdtpu_torch.sample`); the command lines
`python -m sdtpu_torch.sample`, `python -m sdtpu_torch.convert` and
`python -m sdtpu_torch.finetune` take sdtpu's argv (`cli.py`).

Layouts follow sdtpu at every public function: NHWC activations, HWIO
conv weights, `[in, out]` linears, and the reference dump-tree parameter
names. Every sdtpu Pallas kernel on the ported path is a hand-written
CUDA kernel for sm_90a (`csrc/`), built at first use by
`sdtpu_torch.kernels`; each sits beside a plain PyTorch version that its
wrapper runs for CPU tensors.
"""

__version__ = "0.1.0"
