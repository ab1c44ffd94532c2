"""GF(256) data-plane kernels: hand-written CUDA for sm_90a (`csrc/`), their
wrappers, plain PyTorch versions (`ref`) and the byte-level entry points
(`ops`). Importing this package builds nothing; `build.load_library` runs
`nvcc` at the first launch on a CUDA tensor."""
