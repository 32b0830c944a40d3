"""PyTorch/CUDA port of flatquant_tpu: packed W4A4KV4 Llama serving on
NVIDIA Hopper, with hand-written sm_90a kernels (flatquant_torch/kernels).

The JAX package (flatquant_tpu) is the reference; nothing here imports it
or JAX. Module names mirror the JAX package so each counterpart is easy
to find."""
