"""The port's kernels: hand-written CUDA for sm_90a (`csrc/`) — the GF(256)
data plane's, with their wrappers, plain PyTorch versions (`ref`) and the
byte-level entry points (`ops`), and the sweep's event loops
(`event_loop`, wrappers and plain versions side by side). Importing this
package builds nothing; `build.load_library` runs `nvcc` at the first
launch on a CUDA tensor."""
