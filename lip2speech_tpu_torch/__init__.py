"""PyTorch/CUDA port of lip2speech_tpu (the JAX package beside it is the
reference). Modules keep the JAX package's paths and names; the hot ops are
hand-written CUDA kernels for Hopper (sm_90a) under csrc/."""
