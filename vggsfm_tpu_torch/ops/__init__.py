"""Hand-written CUDA kernels of the port, with their plain versions.

`launch_counts` counts kernel launches under the name of the TPU kernel
each one replaces: a wrapper adds to its entry where it launches its
kernel, and nowhere else.
"""

launch_counts = {"fused_transformer_block": 0, "fused_ln_mlp": 0,
                 "fused_ln_attn": 0, "corr_sample_pallas": 0,
                 "corr_sample_pallas_smallc": 0,
                 # no TPU kernel: the long-sequence attention (attention.py)
                 "flash_attention": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
