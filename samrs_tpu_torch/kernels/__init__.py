"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Every wrapper takes the plain version for a CPU tensor and
launches its CUDA kernel (or raises) for a CUDA tensor.

  K1 fused_window_layer.window_layer_attention   (window layer; its modes:
     window order, the residual form, the padded output, and its attention
     stage in fused_window_block (raw qkv map) and fused_attention
     (partitioned windows))
  K2 flash_attention.attention_qkv_relpos        (global attention; modes m,
                                                  split, exp2, aug)
  K3 fused_mlp.ln_mlp_residual                   (LayerNorm + MLP + residual;
     the tail mode fused_tail_ln_mlp_residual)
  K4 fused_twoway.t2i_kv_proj                    (decoder K/V projection)
  K5 fused_twoway.i2t_update                     (decoder image->token update)
  K6 fused_upscale.upscale_hyper                 (upscaling + hypernetwork dot)
  K7 amg_post.amg_postprocess                    (full-resolution mask postprocess)
  K8 bilinear_gather.sample_weighted             (weighted bilinear gather, fwd + bwd)
  K9 bilinear_gather.point_sample                (per-mask point sample, fwd + bwd)
  K10 flash_attention.full_attention             (plain softmax attention, fp32)
  K11 fused_mlp.fused_mlp                        (fc1 -> GELU -> fc2, fp32)
  K12 window_attention.split_attention           (split-head rel-pos attention;
      window_attention_relpos, flash_attention.flash_attention_relpos)
"""
