"""PyTorch/CUDA port of the PiP-MColl collective stack and its consumers:
the DP gradient sync and the serving engine over the dense decoder (the
JAX package ``repro`` is the reference and is never imported from here).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
a ``RankGrid`` places its ranks on the card by default, and the kernels
(codecs, flash decode) launch for CUDA tensors and use their plain
versions only for tensors on the CPU.
"""
