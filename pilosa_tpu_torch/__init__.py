"""pilosa_tpu_torch: the PyTorch/CUDA port of pilosa_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA
H100. It imports nothing of ``jax`` or ``pilosa_tpu``: every module keeps
its own copy of what it needs. Each Pallas kernel of the JAX package on
a ported path is a hand-written CUDA kernel here (``csrc/``), with a
plain PyTorch version beside it that the CPU tests run.

Entry points: ``pilosa_tpu_torch.api.API(device=None)`` — the card by
default, ``device="cpu"`` for the plain versions — and the command line,
``python -m pilosa_tpu_torch <subcommand>`` (``ctl/cli.py``: the HTTP
server, backup, restore, import, export, chksum, datagen, fbsql).
"""

__version__ = "0.1.0"
