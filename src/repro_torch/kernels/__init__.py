"""Hand-written Hopper kernels (``csrc/``), their wrappers and their
plain PyTorch versions. Importing this package builds nothing: a kernel
is compiled the first time a wrapper launches it on a CUDA tensor."""
