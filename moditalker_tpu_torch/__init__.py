"""moditalker_tpu_torch — the PyTorch/CUDA port of ``moditalker_tpu``.

Runs the MToV sampling window (TimeSformer autoencoder extracts, DDIM over
the triplane UNet, decode) on an NVIDIA H100. Every Pallas kernel on that
path is a hand-written CUDA kernel for Hopper (``csrc/``), built at first use
by ``ops/kernels/_build.py``; beside each kernel sits its plain PyTorch
version, which is what runs for tensors on the CPU.

The layout mirrors ``moditalker_tpu`` so each module's counterpart is found
under the same path. The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
