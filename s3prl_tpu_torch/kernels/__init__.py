"""Hopper kernels of the port, one wrapper per Pallas function replaced.

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel for CUDA tensors, and counts its CUDA launches in ``<wrapper>.launches``.
"""


def wrappers():
    """The kernel wrappers of the serving paths, in pipeline order: conv0,
    then the int8 blocks (K1, K2), then the bf16 blocks (K4, K5), then the
    long-utterance attention (K6 int8, K7 bf16, K8 beyond MAX_KERNEL_T),
    then WavLM's gated-bias attention (K9, K10 beyond MAX_KERNEL_T), then
    the fused int8 projections of the opt-in routes (K11 `wavlm_fuse`, K12
    `qkv_fuse` / `full_fuse`), then the front-end options (K13a and K13b
    `int8_conv`, K14 `fused_conv`, K15 `fused_midln`), then the pos-conv
    options (K16a `fused_posconv`, K16b `int8_posconv`), then K17, the
    masked attention on split heads that no model calls: 19 wrappers."""
    from .conv_frontend import (conv0_ln_gelu, conv0_ln_gelu_q8, fused_conv_ln_gelu,
                                fused_int8_conv_ln_gelu)
    from .ffn import fused_bf16_ffn, fused_int8_ffn, fused_int8_linear
    from .flash_attention import (flash_attention, fused_attention_block,
                                  fused_attention_block_bf16, fused_qkv_attention,
                                  fused_qkv_attention_outproj, gated_bias_attention,
                                  gated_bias_attention_outproj, gated_online_flash_attention,
                                  online_flash_attention)
    from .ln_gelu import ln_gelu
    from .posconv import pos_conv_gelu, pos_conv_gelu_q8

    return (conv0_ln_gelu, fused_attention_block, fused_int8_ffn,
            fused_attention_block_bf16, fused_bf16_ffn, fused_qkv_attention_outproj,
            fused_qkv_attention, online_flash_attention, gated_bias_attention,
            gated_online_flash_attention, gated_bias_attention_outproj, fused_int8_linear,
            conv0_ln_gelu_q8, fused_int8_conv_ln_gelu, fused_conv_ln_gelu, ln_gelu,
            pos_conv_gelu, pos_conv_gelu_q8, flash_attention)
