"""Hand-written CUDA kernels for Hopper (counterpart of
``deepspeed_tpu/ops/pallas``), each beside its plain PyTorch version."""
