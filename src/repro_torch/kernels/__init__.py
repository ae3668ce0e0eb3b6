"""The port's kernels: hand-written CUDA C++ for sm_90a (`csrc/`), built by
`build.py`, bound by the wrappers in `attention.py` and `matmul.py`, and
exposed with the JAX package's signatures in `ops.py`.  `ref.py` holds the
plain PyTorch version of each kernel."""
