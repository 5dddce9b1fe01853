# Hand-written CUDA kernels for Hopper (csrc/*.cu), their plain PyTorch
# versions (ref.py) and the wrappers that pick between them by the device
# of the tensors they are given (ops.py).  Nothing is built at import.
