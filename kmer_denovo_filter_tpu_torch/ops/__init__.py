"""Device k-mer ops: int64 keys, plain PyTorch versions, CUDA kernels."""
