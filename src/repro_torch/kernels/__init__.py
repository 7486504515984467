"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(port of ``repro.kernels``).

``exchange`` (the lattice exchange: fused rotate+encode, rotate, quantize,
snap, fused decode), ``flash_attention``, ``grouped_mm`` (the MoE's grouped
product over rows sorted by expert, forward, dgrad and wgrad, group offsets
read on the card), ``hadamard`` (blocked Hadamard transform),
``lattice_quant`` (single-vector lattice encode and decode),
``ops`` (the public API over them, with ``rotate_blocks``) and ``build``
(nvcc, ctypes and what every wrapper does around a launch)."""
