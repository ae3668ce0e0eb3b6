"""The port's examples: the JAX package's `examples/` scripts over the
port's APIs, each a module with `main(argv=None)` run as

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.tune_resnet18 [--rl]
    PYTHONPATH=src python -m repro_torch.examples.serve_inference [--requests 12]

on the GPU, or with `--device cpu` on the plain PyTorch path.  Each takes
its JAX example's arguments and defaults and runs at its size.
`examples/train_lm.py`'s counterpart is `python -m repro_torch.train`.
"""
