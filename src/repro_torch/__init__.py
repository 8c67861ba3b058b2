"""repro_torch: PyTorch/CUDA port of "Fast Entropy Decoding for Sparse MVM
on GPUs", for NVIDIA Hopper (H100).

The numpy host codec (``core``, ``sparse``, ``kernels.pack``) is carried
over byte for byte from the JAX package ``repro``, which stays the
reference. The decode-on-the-fly SpMV/SpMM runs through hand-written CUDA
kernels (``kernels/csrc/dtans_spmv.cu``) on the card, and through a plain
torch lock-step decoder (``kernels.common``) on the CPU.

Nothing here imports JAX or the ``repro`` package, and importing sets no
global flag: 64-bit decoder lanes are explicit ``torch.int64`` tensors.
Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
