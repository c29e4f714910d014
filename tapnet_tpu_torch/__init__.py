"""PyTorch/CUDA port of tapnet_tpu's TAPIR tracker.

The package mirrors `tapnet_tpu`'s layout so each module's counterpart is
easy to find, but imports only `torch` and numpy. The JAX package stays the
numerical reference; the tests hold this port against it.

Device rule, shared by every entry point and kernel wrapper:

  * an entry point (`inference.TapirPredictor`) runs on the CUDA card unless
    the caller passes `device="cpu"`; without a card it raises;
  * a kernel wrapper (`ops.corr_tents.corr_tent_patches`,
    `ops.fused_mixer_block.mixer_block`) runs its plain PyTorch version for a
    CPU tensor and launches its hand-written CUDA kernel for a CUDA tensor.
    There is no fallback from the kernel to the plain version.

The CUDA kernels are compiled from `csrc/` at their first launch
(`ops/_build.py`), so importing the package needs no CUDA toolchain.
"""
