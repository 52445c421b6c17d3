"""Hopper kernels of the port, one wrapper per Pallas function replaced.

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors, and counts its CUDA launches in ``<wrapper>.launches``.
"""


def wrappers():
    """The kernel wrappers of the serving path, in pipeline order."""
    from .conv_frontend import conv0_ln_gelu
    from .ffn import fused_bf16_ffn
    from .flash_attention import fused_attention_block_bf16

    return (conv0_ln_gelu, fused_attention_block_bf16, fused_bf16_ffn)
