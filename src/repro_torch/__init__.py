"""PyTorch/CUDA port of `repro` for one NVIDIA H100 (sm_90a).

The package mirrors `repro`'s module names so each counterpart is easy to
find.  It imports `torch` and numpy only — never `jax`, and nothing of the
`repro` package — and keeps its own copies of the pure-Python modules it
needs.  The hot path of the continuous-batching server runs three kernels
written by hand in CUDA C++ (`repro_torch/kernels/csrc/`), built with
`nvcc` on first use; every kernel has a plain PyTorch version in
`repro_torch.kernels.ref` that CPU tensors take instead.

Entry points take an explicit `device`; the default is CUDA and raises
when no GPU is present (`repro_torch.platform.default_device`).
"""
